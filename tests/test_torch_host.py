"""The port's host-side copies against the JAX package's originals:
tokenization and blocking, shard planning, token sampling, and the
activation store's three locations."""

import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu.parallel import planner as jplanner
from flexible_llm_sharding_tpu.runtime import generation as jgeneration
from flexible_llm_sharding_tpu.runtime import tokenization as jtok
from flexible_llm_sharding_tpu_torch.parallel import planner
from flexible_llm_sharding_tpu_torch.runtime import generation, tokenization
from flexible_llm_sharding_tpu_torch.runtime.activations import ActivationStore

PROMPTS = [
    ("a b c", (" d", " e f g")),
    ("one two three four five six seven", (" x",)),
    ("p q", (" r s", " t", " u v w x y z")),
    ("a b c", (" z z",)),
]


def _fields(t):
    return (t.prefix_ids, t.suffix_ids, t.prefix_len, t.suffix_eos, t.num_suffixes)


@pytest.mark.parametrize("bucket", [4, 64])
def test_tokenization_and_blocks_match_jax(bucket):
    mine = tokenization.PromptTokenizer(BenchTokenizer(), max_token_len=32, bucket_multiple=bucket)
    ref = jtok.PromptTokenizer(BenchTokenizer(), max_token_len=32, bucket_multiple=bucket)
    toks, jtoks = [mine(*p) for p in PROMPTS], [ref(*p) for p in PROMPTS]
    for a, b in zip(toks, jtoks):
        for x, y in zip(_fields(a), _fields(b)):
            np.testing.assert_array_equal(x, y)
        assert a.tokens_processed == b.tokens_processed
    assert tokenization.make_blocks(toks, 2) == jtok.make_blocks(jtoks, 2)
    gen = np.array([[7, 8], [9, 10]], np.int32)
    a = tokenization.extend_tokenized(toks[0], gen, 2, bucket, 32)
    b = jtok.extend_tokenized(jtoks[0], gen, 2, bucket, 32)
    for x, y in zip(_fields(a), _fields(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_layers,per_shard", [(7, 1), (7, 2), (35, 4), (3, 5)])
def test_planner_matches_jax(n_layers, per_shard):
    assert planner.plan_shards_dp(n_layers, per_shard).shards == \
        jplanner.plan_shards_dp(n_layers, per_shard).shards
    for n_batch in (1, 2, 3):
        assert planner.batch_ranges(10, n_batch) == jplanner.batch_ranges(10, n_batch)


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.7, 0, 0.0), (1.3, 5, 0.0), (1.0, 0, 0.8)])
def test_sampling_matches_jax(temperature, top_k, top_p):
    dist = np.random.default_rng(0).dirichlet(np.ones(50), size=6).astype(np.float32)
    got = generation.sample_tokens(dist, np.random.default_rng(4), temperature, top_k, top_p)
    want = jgeneration.sample_tokens(dist, np.random.default_rng(4), temperature, top_k, top_p)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("location,max_in_cpu", [("gpu", None), ("cpu", None), ("cpu", 1),
                                                 ("disk", None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_store_round_trips(tmp_path, location, max_in_cpu, dtype):
    store = ActivationStore(location, torch.device("cpu"), dtype, str(tmp_path),
                            max_in_cpu=max_in_cpu)
    blocks = {0: [0, 1], 1: [2]}
    data = {b: (torch.randn(len(i), 3, 4).to(dtype), torch.randn(len(i), 2, 5, 4).to(dtype))
            for b, i in blocks.items()}
    for b, idxs in blocks.items():
        store.store(b, idxs, *data[b])
    for b, idxs in blocks.items():
        p, s = store.fetch(b, idxs, with_prefix=b == 0)
        assert torch.equal(s, data[b][1]) and s.dtype == dtype
        assert (p is None) == (b != 0)
        if p is not None:
            assert torch.equal(p, data[b][0])
