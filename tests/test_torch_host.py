"""The port's host-side copies against the JAX package's originals:
tokenization and blocking, shard planning, token sampling, and the
activation store's three locations."""

import os

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


# -- the host path: activations, readahead, the CLI's defaults ----------------

def test_cpu_store_keeps_at_most_one_block_pending():
    store = ActivationStore("cpu", torch.device("cpu"), torch.float32)
    data = {b: (torch.randn(1, 3, 4), torch.randn(1, 2, 5, 4)) for b in range(4)}
    for b, (p, s) in data.items():
        store.store(b, [b], p, s)
        assert store._pending == [b]
    for b, (p, s) in data.items():
        got_p, got_s = store.fetch(b, [b])
        assert torch.equal(got_p, p) and torch.equal(got_s, s)
    assert store._pending == []


@pytest.mark.parametrize("batch", [0, 3])
def test_disk_file_names_ping_pong_as_jax(tmp_path, batch):
    from flexible_llm_sharding_tpu.runtime.activations import ActivationStore as JStore

    mine = ActivationStore("disk", torch.device("cpu"), torch.float32, str(tmp_path), batch=batch)
    ref = JStore("disk", str(tmp_path), batch=batch)
    for shard in range(4):
        mine.set_shard(shard)
        ref.set_shard(shard)
        assert (mine._store_gen, mine._fetch_gen) == (ref._store_gen, ref._fetch_gen)
        for idx in (0, 7, 12345):
            for gen in (0, 1):
                assert mine._paths(idx, gen) == ref._paths(idx, gen)


def test_disk_generations_keep_a_shards_inputs(tmp_path):
    """Shard k reads generation (k-1) % 2 and writes k % 2: its stores never
    overwrite the files it reads."""
    store = ActivationStore("disk", torch.device("cpu"), torch.float32, str(tmp_path))
    x = [torch.full((1, 2, 3), float(k)) for k in range(3)]
    store.set_shard(0)
    store.store(0, [0], x[0], x[0][:, None])
    for k in (1, 2):
        store.set_shard(k)
        p, s = store.fetch(0, [0])
        assert torch.equal(p, x[k - 1]) and torch.equal(s, x[k - 1][:, None])
        store.store(0, [0], x[k], x[k][:, None])
    store.flush()
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npy"))
    assert names == ["prefix-00000.g1.npy", "prefix-00000.npy", "suffix-00000.g1.npy",
                     "suffix-00000.npy"]
    store.clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_spill_sidecar_is_jax_sidecar(tmp_path, dtype):
    from flexible_llm_sharding_tpu.integrity import manifest as jman

    store = ActivationStore("disk", torch.device("cpu"), dtype, str(tmp_path / "port"))
    s = torch.randn(1, 2, 3, 8).to(dtype)
    store.store(0, [0], None, s)
    store.flush()
    spill = tmp_path / "port" / "suffix-00000.npy"
    arr = np.load(spill)
    os.makedirs(tmp_path / "jax")
    ref = tmp_path / "jax" / "x.npy"
    want = s[0].view(torch.uint16).numpy() if dtype == torch.bfloat16 else s[0].numpy()
    np.testing.assert_array_equal(arr, want)
    jman.write_sidecar(str(ref), want)
    assert (tmp_path / "port" / "suffix-00000.npy.crc").read_bytes() == \
        (tmp_path / "jax" / "x.npy.crc").read_bytes()
    _, got = store.fetch(0, [0], with_prefix=False)
    assert got.dtype == dtype and torch.equal(got, s)


@pytest.mark.parametrize("location,max_in_cpu", [("disk", None), ("cpu", 0)])
def test_corrupt_spill_raises_spill_corrupt(tmp_path, location, max_in_cpu):
    from flexible_llm_sharding_tpu_torch.integrity.manifest import SpillCorruptError
    from flexible_llm_sharding_tpu_torch.utils.metrics import IntegrityRecorder

    rec = IntegrityRecorder()
    store = ActivationStore(location, torch.device("cpu"), torch.float32, str(tmp_path),
                            max_in_cpu=max_in_cpu, integrity=rec)
    store.store(0, [0], torch.randn(1, 4, 8), torch.randn(1, 2, 3, 8))
    store.flush()
    path = tmp_path / "suffix-00000.npy"
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0x10
    path.write_bytes(bytes(raw))
    with pytest.raises(SpillCorruptError, match="suffix-00000.npy"):
        store.fetch(0, [0])
    assert rec.total("integrity_failures") == 3


def test_file_prefetcher_builds_natively_and_leaves_bytes(tmp_path):
    from flexible_llm_sharding_tpu_torch.utils.native import FilePrefetcher

    path = tmp_path / "layer.bin"
    payload = np.random.default_rng(0).bytes(1 << 20)
    path.write_bytes(payload)
    pf = FilePrefetcher(threads=2)
    assert pf.native
    pf.prefetch(str(path), str(tmp_path / "missing.bin"))
    pf.wait_all()
    pf.close()
    pf.prefetch(str(path))  # a no-op after close
    assert path.read_bytes() == payload


class _Vocab256(BenchTokenizer):
    VOCAB = 256


HOST_CLI_PROMPTS = [
    ("the quick brown fox jumps over the lazy dog " * 3, (" and runs", " then sleeps all day")),
    ("one two three four five six seven eight nine ten eleven twelve",
     (" thirteen fourteen", " x", " y z")),
    ("a b c d e", (" f",)),
]
OFF = ["--host_cache_gb", "0", "--verify_weights", "false", "--readahead_threads", "0"]


def _host_cli(main, model_dir, tmp_path, tag, extra):
    import pickle

    ppkl, opkl = tmp_path / f"{tag}.pkl", tmp_path / f"{tag}_scores.pkl"
    ppkl.write_bytes(pickle.dumps(HOST_CLI_PROMPTS))
    stats = main(["--model_path", str(model_dir), "--prompt_pickle", str(ppkl), "--output_file",
                  str(opkl), "--dtype", "float32", "--bucket_multiple", "16", "--block_size", "2",
                  "--disk_folder", str(tmp_path / f"{tag}_disk"), *extra],
                 tokenizer=_Vocab256())
    return (pickle.loads(opkl.read_bytes()),
            pickle.loads((tmp_path / f"{tag}_updated.pkl").read_bytes()), stats)


@pytest.fixture(scope="module")
def host_models(tmp_path_factory):
    """A tiny llama and a tiny tied gemma 3, split by the JAX splitter."""
    from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
    from test_torch_checkpoint import hf_checkpoint

    root = tmp_path_factory.mktemp("host_models")
    out = {}
    for family in ("llama", "gemma3"):
        hf_checkpoint(family, root / f"{family}_hf", seed=4)
        jckpt.split_into_layers(str(root / f"{family}_hf"), str(root / family), dtype="float32")
        out[family] = root / family
    return out


@pytest.mark.parametrize("mode", [["--num_gen_token", "3"],
                                  ["--num_gen_token", "3", "--kv_cache", "true"],
                                  ["--num_batch", "2"]],
                         ids=["generation_loop", "kv_cache", "num_batch"])
@pytest.mark.parametrize("family", ["llama", "gemma3"])
def test_cli_host_path_defaults(host_models, tmp_path, family, mode):
    """The defaults give the scores of everything off bit for bit, the JAX
    CLI's within atol 1e-5, and the JAX run's host-cache hits and misses."""
    from flexible_llm_sharding_tpu.cli import main as jax_main
    from flexible_llm_sharding_tpu.integrity import manifest as jman
    from flexible_llm_sharding_tpu.runtime import hostcache as jhostcache
    from flexible_llm_sharding_tpu_torch.cli import main as torch_main
    from flexible_llm_sharding_tpu_torch.integrity import manifest
    from flexible_llm_sharding_tpu_torch.runtime import hostcache

    model = host_models[family]
    jhostcache.reset_process_cache()
    jman.reset_verdicts()
    want, want_up, _ = _host_cli(jax_main, model, tmp_path, "jax", [*mode, "--num_devices", "1"])
    jstats = jhostcache.process_cache().stats()
    jverdicts = jman.verdict_stats()
    jhostcache.reset_process_cache()
    runs = {}
    for tag, extra in (("on", []), ("off", OFF)):
        hostcache.reset_process_cache()
        manifest.reset_verdicts()
        runs[tag] = _host_cli(torch_main, model, tmp_path, tag, [*mode, "--device", "cpu", *extra])
    hostcache.reset_process_cache()
    (got, got_up, stats), (off, off_up, off_stats) = runs["on"], runs["off"]
    for g, o, w in zip(got, off, want):
        np.testing.assert_array_equal(g, o)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert got_up == off_up == want_up
    assert (stats["host_cache_hits"], stats["host_cache_misses"]) == \
        (jstats["hits"], jstats["misses"])
    assert stats["host_cache_hits"] > 0
    assert (stats["crc_full_verifies"], stats.get("crc_verdict_hits", 0)) == \
        (jverdicts["full_verifies"], jverdicts["verdict_hits"])
    assert "host_cache_hits" not in off_stats and "crc_full_verifies" not in off_stats


@pytest.mark.parametrize("layer", ["model.layers.1", "model.embed_tokens"])
def test_rot_drill_raises_after_a_warm_run(host_models, tmp_path, layer):
    """Warm the process cache and the verdicts, flip a byte, run again: the
    stat guards drop the stale entries and the re-read raises."""
    import shutil

    from flexible_llm_sharding_tpu_torch.cli import main as torch_main
    from flexible_llm_sharding_tpu_torch.integrity.manifest import ShardCorruptError
    from flexible_llm_sharding_tpu_torch.runtime import hostcache

    model = tmp_path / "model"
    shutil.copytree(host_models["gemma3"], model)
    hostcache.reset_process_cache()
    args = ["--num_gen_token", "2", "--device", "cpu", "--io_retry_base_s", "0"]
    _, _, warm = _host_cli(torch_main, model, tmp_path, "warm", args)
    assert warm["host_cache_hits"] > 0
    path = model / f"{layer}.safetensors"
    raw = bytearray(path.read_bytes())
    raw[-7] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(ShardCorruptError, match=layer):
        _host_cli(torch_main, model, tmp_path, "rot", args)
    hostcache.reset_process_cache()
