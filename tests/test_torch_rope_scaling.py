"""The port's rope scalings against the JAX package's, on the CPU in float32:
the frequency tables of llama3, yarn (with and without DeepSeek's
mscale_all_dim) and longrope (both factor lists), the cos/sin tables with
their attention factor (longrope on both sides of its original context
length, chosen per sequence), the attention factor itself and the
interleaved rotation; the published Llama-3.1-8B config's scaling; and the
batch CLI against the JAX CLI on tiny transformers checkpoints (random
init, save_pretrained) of a llama3-scaled Llama, a yarn Qwen2 and a
longrope Phi-3, split by each package's splitter, in the re-scoring loop
and with --kv_cache. Tables and rotations within atol 1e-5 (the frequency
tables bit-exact), CLI scores within atol 1e-5 with identical greedy
tokens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.cli import main as jax_main
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.ops import rope as jrope
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.cli import main as torch_main
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.ops import rope
from flexible_llm_sharding_tpu_torch.utils import checkpoint
from tests.test_torch_checkpoint import (
    HF_ROPE_FAMILIES,
    _assert_same_split,
    assert_cli_match,
    hf_checkpoint,
    run_cli,
)

ATOL = 1e-5


def _longrope(hd: int) -> tuple:
    long_f = tuple(1.0 + 0.5 * i for i in range(hd // 2))
    short_f = tuple(1.0 + 0.03 * i for i in range(hd // 2))
    return ("longrope", long_f, short_f, 4096, 1.19)


# The scaling specs (LlamaConfig.rope_scaling_spec) by name, at a head dim.
SPECS = {
    "llama3": lambda hd: ("llama3", 8.0, 1.0, 4.0, 8192),
    "yarn": lambda hd: ("yarn", 4.0, 32.0, 1.0, 32768, 1.1386294361119891, True),
    "yarn-deepseek": lambda hd: ("yarn", 40.0, 32.0, 1.0, 4096, 1.0, True),
    "yarn-untruncated": lambda hd: ("yarn", 8.0, 32.0, 1.0, 2048, 1.2079441541679836, False),
    "longrope": _longrope,
}


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("name", ["llama3", "yarn", "yarn-deepseek", "yarn-untruncated",
                                  "longrope-long", "longrope-short"])
def test_inv_freq_matches_jax_bit_exact(name, hd):
    if name.startswith("longrope"):
        spec = _longrope(hd)
        spec = ("longrope_ext", spec[1] if name.endswith("long") else spec[2])
    else:
        spec = SPECS[name](hd)
    theta = 10000.0 if name != "llama3" else 500000.0
    np.testing.assert_array_equal(rope._inv_freq(hd, theta, spec), jrope._inv_freq(hd, theta, spec))


@pytest.mark.parametrize("name", list(SPECS) + [None])
def test_rope_attention_scale_matches_jax(name):
    spec = SPECS[name](64) if name else None
    assert rope.rope_attention_scale(spec) == jrope.rope_attention_scale(spec)


@pytest.mark.parametrize("total", ["short", "long", "per-sequence"])
def test_longrope_cos_sin_picks_its_table_by_length(total):
    """Positions [B, L] with one real length per sequence: below the
    original context length (4096) the short factors, above it the long
    ones; the JAX tables per sequence."""
    hd = 64
    spec = _longrope(hd)
    pos = np.random.default_rng(3).integers(0, 8000, size=(2, 9)).astype(np.int32)
    lens = {"short": [4000, 12], "long": [5000, 8000], "per-sequence": [4096, 4097]}[total]
    c, s = rope.rope_cos_sin(torch.from_numpy(pos), hd, 10000.0, spec,
                             total_len=torch.tensor(lens, dtype=torch.int32))
    for b in range(2):
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos[b]), hd, 10000.0, spec, total_len=jnp.int32(lens[b]))
        np.testing.assert_allclose(c[b].numpy(), np.asarray(jc), atol=ATOL, rtol=0)
        np.testing.assert_allclose(s[b].numpy(), np.asarray(js), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="total_len"):
        rope.rope_cos_sin(torch.from_numpy(pos), hd, 10000.0, spec)


@pytest.mark.parametrize("name", ["llama3", "yarn", "yarn-deepseek", "yarn-untruncated"])
def test_rope_cos_sin_matches_jax(name):
    hd = 64
    pos = np.random.default_rng(4).integers(0, 40000, size=(3, 7)).astype(np.int32)
    c, s = rope.rope_cos_sin(torch.from_numpy(pos), hd, 10000.0, SPECS[name](hd))
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), hd, 10000.0, SPECS[name](hd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_interleaved_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    spec = SPECS["yarn-deepseek"](64)
    c, s = rope.rope_cos_sin(torch.from_numpy(pos), 64, 10000.0, spec)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 64, 10000.0, spec)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = rope.apply_rope_interleaved(tx, c, s)
    want = jrope.apply_rope_interleaved(jnp.asarray(x, dtype=jnp.dtype(dtype)), jc, js)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=ATOL if dtype == "float32" else 2**-7, rtol=0)


# meta-llama/Llama-3.1-8B, config.json (the keys that reach a config parser).
LLAMA31_8B = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 128000, "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336, "max_position_embeddings": 131072,
    "mlp_bias": False, "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 128256,
}


def test_llama31_rope_tables_match_jax():
    """Llama-3.1-8B's scaling, parsed by each package, gives the same cos/sin
    at positions past its original 8192."""
    cfg, jcfg = LlamaConfig.from_dict(LLAMA31_8B), JLlamaConfig.from_hf_config(LLAMA31_8B)
    assert cfg.rope_scaling_spec == jcfg.rope_scaling_spec == ("llama3", 8.0, 1.0, 4.0, 8192)
    pos = np.arange(0, 60000, 997, dtype=np.int32)[None]
    c, s = rope.rope_cos_sin(torch.from_numpy(pos), cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_spec)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta, jcfg.rope_scaling_spec)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", [[], ["--kv_cache", "true"]], ids=["generation_loop", "kv_cache"])
@pytest.mark.parametrize("family", HF_ROPE_FAMILIES)
def test_scaled_rope_cli_matches_jax_cli(tmp_path, family, mode):
    """Each package's splitter on the same transformers checkpoint writes
    the same files; the port's CLI on its split gives the JAX CLI's scores
    and tokens on the JAX split (phi3_longrope: one prompt on each side of
    its original context length of 24)."""
    hf_checkpoint(family, tmp_path / "hf", seed=2)
    checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"), dtype="float32")
    jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), dtype="float32")
    _assert_same_split(tmp_path / "port", tmp_path / "jax")
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "port"))
    assert cfg.rope_scaling_kind == {"llama3": "llama3", "qwen2_yarn": "yarn",
                                     "phi3_longrope": "longrope"}[family]
    extra = ["--num_gen_token", "3", *mode]
    want = run_cli(jax_main, tmp_path / "jax", tmp_path, "jax", [*extra, "--num_devices", "1"])
    got = run_cli(torch_main, tmp_path / "port", tmp_path, "torch", [*extra, "--device", "cpu"])
    assert_cli_match(got, want)


def test_longrope_prompt_straddling_the_boundary_raises(tmp_path):
    """A prompt whose suffixes fall on both sides of longrope's original
    context length cannot share one prefix KV: the port refuses it, as the
    JAX package does."""
    from flexible_llm_sharding_tpu_torch.runtime.tokenization import check_longrope_regime

    hf_checkpoint("phi3_longrope", tmp_path / "hf")
    checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"))
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "port"))

    class Tok:
        prefix_len, num_suffixes = 20, 2
        suffix_eos = np.array([1, 8, 0, 0])

    with pytest.raises(ValueError, match="straddle"):
        check_longrope_regime(cfg, [Tok()])
    Tok.suffix_eos = np.array([0, 2, 0, 0])
    check_longrope_regime(cfg, [Tok()])
    with pytest.raises(ValueError, match="straddle"):
        check_longrope_regime(cfg, [Tok()], extra_len=3)
