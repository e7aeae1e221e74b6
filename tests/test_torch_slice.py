"""The port's batch CLI end to end on the CPU against the JAX package's batch
CLI: the same checkpoint, prompt pickle and tokenizer, float32. Scores agree
to atol 1e-5 / rtol 1e-4 and the updated prompts are identical, for the
reference generation loop and for KV-cache decode."""

import pickle

import jax
import numpy as np
import pytest

from bench import BenchTokenizer
from flexible_llm_sharding_tpu.cli import main as jax_main
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.utils.checkpoint import save_params as jax_save_params
from flexible_llm_sharding_tpu_torch.cli import main as torch_main


class SmallVocabTokenizer(BenchTokenizer):
    """The bench's word-hash tokenizer over the test model's 512-token vocab."""

    VOCAB = 512


PROMPTS = [
    ("the quick brown fox jumps over the lazy dog " * 3, (" and runs", " then sleeps all day")),
    ("a b c d e", (" f",)),
    ("one two three four five six seven eight nine ten eleven twelve",
     (" thirteen fourteen", " x", " y z")),
    ("lorem ipsum dolor sit amet", (" consectetur", " adipiscing elit sed")),
]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_slice_model")
    cfg = JLlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = jllama.init_params(jax.random.PRNGKey(7), cfg)
    jax_save_params(jax.tree.map(np.asarray, params), str(d), cfg)
    return str(d)


def _run(main, model_dir, tmp_path, tag, extra):
    ppkl = tmp_path / f"{tag}.pkl"
    opkl = tmp_path / f"{tag}_scores.pkl"
    with open(ppkl, "wb") as f:
        pickle.dump(PROMPTS, f)
    main(
        ["--model_path", model_dir, "--prompt_pickle", str(ppkl), "--output_file", str(opkl),
         "--dtype", "float32", "--bucket_multiple", "16", "--block_size", "2",
         "--disk_folder", str(tmp_path / f"{tag}_disk"), *extra],
        tokenizer=SmallVocabTokenizer(),
    )
    with open(opkl, "rb") as f:
        scores = pickle.load(f)
    with open(tmp_path / f"{tag}_updated.pkl", "rb") as f:
        updated = pickle.load(f)
    return scores, updated


@pytest.mark.parametrize("extra", [
    ["--num_gen_token", "3"],
    ["--num_gen_token", "3", "--kv_cache", "true"],
], ids=["generation_loop", "kv_cache"])
def test_cli_matches_jax_cli(model_dir, tmp_path, extra):
    want, want_up = _run(jax_main, model_dir, tmp_path, "jax", [*extra, "--num_devices", "1"])
    got, got_up = _run(torch_main, model_dir, tmp_path, "torch", [*extra, "--device", "cpu"])
    assert len(got) == len(want) == len(PROMPTS)
    for g, w, (_, sfx) in zip(got, want, PROMPTS):
        assert g.shape == w.shape == (len(sfx), 3, 512)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    assert got_up == want_up


def test_tied_embeddings_match_jax_cli(tmp_path):
    """With tied embeddings the lm_head streams from the embedding file."""
    cfg = JLlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=4,
                       tie_word_embeddings=True)
    d = str(tmp_path / "tied")
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(3), cfg))
    jax_save_params(params, d, cfg)
    extra = ["--num_gen_token", "2", "--layer_num_per_shard", "2"]
    want, want_up = _run(jax_main, d, tmp_path, "jax", [*extra, "--num_devices", "1"])
    got, got_up = _run(torch_main, d, tmp_path, "torch", [*extra, "--device", "cpu"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    assert got_up == want_up


@pytest.mark.parametrize("storage", [
    ["--storage_location", "gpu"],
    ["--storage_location", "disk"],
    ["--storage_location", "cpu", "--max_activation_in_cpu", "2"],
], ids=["gpu", "disk", "cpu_spill"])
def test_storage_locations_give_identical_scores(model_dir, tmp_path, storage):
    """'gpu' keeps activations in the device's own memory — here the CPU's."""
    base = ["--num_gen_token", "2", "--device", "cpu", "--layer_num_per_shard", "2"]
    want, want_up = _run(torch_main, model_dir, tmp_path, "cpu",
                         [*base, "--storage_location", "cpu"])
    got, got_up = _run(torch_main, model_dir, tmp_path, "other", [*base, *storage])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_up == want_up


def test_sampling_is_seeded_and_kv_cache_greedy_matches_loop(model_dir, tmp_path):
    """Sampled runs repeat under one seed; greedy KV-cache decode picks the
    same tokens as the re-scoring loop."""
    samp = ["--num_gen_token", "3", "--device", "cpu", "--temperature", "0.8", "--top_k", "50",
            "--kv_cache", "true"]
    a, a_up = _run(torch_main, model_dir, tmp_path, "s1", [*samp, "--seed", "3"])
    b, b_up = _run(torch_main, model_dir, tmp_path, "s2", [*samp, "--seed", "3"])
    assert a_up == b_up
    loop, _ = _run(torch_main, model_dir, tmp_path, "loop", ["--num_gen_token", "3", "--device", "cpu"])
    kv, _ = _run(torch_main, model_dir, tmp_path, "kv",
                 ["--num_gen_token", "3", "--device", "cpu", "--kv_cache", "true"])
    for g, w in zip(kv, loop):
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
