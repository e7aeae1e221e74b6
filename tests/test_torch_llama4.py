"""Llama 4's text model in the port against the JAX package's, on the CPU in
float32, from the same seeded numpy inputs, within atol 1e-5: the L2 q/k
norm, the per-layer position treatment (rope layers with the post-rope L2
norm, NoPE layers with temperature-tuned queries), the input-scaled MoE
beside its shared expert, and the prefix/suffix and decode layer functions
on the JAX tests' tiny ``LLAMA4_CFG`` (dense and MoE layers, a chunk of 4
that binds, a NoPE layer, floor scale 4) and on a GQA group of 5 (Llama 4
Scout's 40/8 heads at 10/2); Scout's published text config parsed as the
JAX package parses it, rope table included; transformers checkpoints, bare
and as the multimodal wrapper, split by both packages into the same
tensors in bf16, int8 and int4; and the batch CLI against the JAX CLI in
the re-scoring loop, --kv_cache, --speculative_k 2 and the resident and
fused decode modes (scores within 1e-5, tokens equal)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.cli import main as jax_main
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.ops import rope as jrope
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.cli import main as torch_main
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops import rope
from flexible_llm_sharding_tpu_torch.utils import checkpoint
from tests.test_model_families import LLAMA4_CFG
from tests.test_torch_checkpoint import _assert_same_split, assert_cli_match, run_cli

ATOL = 1e-5
# Scout's GQA group of 5 (40 query heads over 8 KV heads), at 10 over 2.
CFGS = {"tiny": LLAMA4_CFG,
        "gqa5": dataclasses.replace(LLAMA4_CFG, hidden_size=40, num_attention_heads=10)}


def _port(jcfg: JLlamaConfig) -> LlamaConfig:
    return LlamaConfig.from_dict({**dataclasses.asdict(jcfg), "fls_native": True})


def _params(jcfg: JLlamaConfig, seed: int) -> dict:
    """Seeded weights in the JAX package's layout (numpy), norm scales
    redrawn around 1 so their placement shows."""
    params = jax.tree.map(np.array, jllama.init_mixed_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for key in ("input_layernorm", "post_attention_layernorm"):
            layer[key]["scale"] = (1.0 + rng.normal(0, 0.3, layer[key]["scale"].shape)).astype(
                np.float32)
    return params


def _x(rng, *shape):
    return (rng.standard_normal(shape) * 0.7).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Position treatment and the MoE
# ---------------------------------------------------------------------------

def test_l2_norm_matches_jax():
    x = _x(np.random.default_rng(0), 3, 5, 4, 8)
    got = llama._l2_norm(_t(x), 1e-5)
    want = jllama._l2_norm(jnp.asarray(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("rope_on", [True, False], ids=["rope", "nope"])
@pytest.mark.parametrize("name", list(CFGS))
def test_position_qk_matches_jax(name, rope_on):
    """Rope layers: interleaved rope, then the L2 norm; the NoPE layer: q/k
    unrotated, q scaled by the temperature of its position (which moves
    from position 3 on at floor scale 4)."""
    jcfg = CFGS[name]
    cfg = _port(jcfg)
    rng = np.random.default_rng(1)
    nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k = _x(rng, 2, 17, nq, hd), _x(rng, 2, 17, nkv, hd)
    pos = np.arange(17, dtype=np.int32)[None] + np.array([[0], [9]], np.int32)
    gq, gk = llama.position_qk(cfg, _t(q), _t(k), _t(pos), sliding=True, rope_on=rope_on)
    for b in range(2):
        wq, wk = jllama.position_qk(jcfg, jnp.asarray(q[b]), jnp.asarray(k[b]),
                                    jnp.asarray(pos[b]), True, rope_on)
        np.testing.assert_allclose(gq[b].numpy(), np.asarray(wq), atol=ATOL, rtol=0)
        np.testing.assert_allclose(gk[b].numpy(), np.asarray(wk), atol=ATOL, rtol=0)
    if not rope_on:
        assert torch.equal(gk, _t(k)) and not torch.equal(gq, _t(q))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", list(CFGS))
def test_llama4_moe_mlp_matches_jax(name, k):
    jcfg = dataclasses.replace(CFGS[name], num_experts_per_tok=k)
    cfg = _port(jcfg)
    mlp = _params(jcfg, 3)["layers"][1]["mlp"]
    assert "shared_gate" in mlp and "correction_bias" not in mlp
    x = _x(np.random.default_rng(4), 3, 6, cfg.hidden_size)
    got = llama._mlp([{key: _t(v) for key, v in mlp.items()}], cfg, _t(x))
    want = jllama._mlp(jax.tree.map(jnp.asarray, mlp), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_llama4_unselected_experts_add_exactly_nothing():
    """An expert no token selects never runs: an overflow in its weights
    reaches no output."""
    cfg = _port(LLAMA4_CFG)
    mlp = {k: _t(v) for k, v in _params(LLAMA4_CFG, 5)["layers"][1]["mlp"].items()}
    x = _t(_x(np.random.default_rng(6), 1, 2, cfg.hidden_size))
    chosen = set(llama._top_k(x @ mlp["router"], 1)[1].flatten().tolist())
    unused = [e for e in range(cfg.num_local_experts) if e not in chosen]
    assert unused
    base = llama._mlp([mlp], cfg, x)
    mlp["up"][unused[0]] = float("inf")
    out = llama._mlp([mlp], cfg, x)
    assert torch.isfinite(out).all() and torch.equal(out, base)


# ---------------------------------------------------------------------------
# The layer functions
# ---------------------------------------------------------------------------

B, LP, S, LS, T = 2, 16, 2, 8, 3
PLEN = np.array([13, 5], np.int32)
EOS = np.array([[2, 7], [0, 4]], np.int32)


def _layer_model(name):
    jcfg = CFGS[name]
    params_np = _params(jcfg, 9)
    cfg = _port(jcfg)
    return jcfg, cfg, params_np, checkpoint.params_from_jax(params_np, cfg)


@pytest.mark.parametrize("layer", [0, 1, 2], ids=["chunked-dense", "chunked-moe", "nope-dense"])
@pytest.mark.parametrize("name", list(CFGS))
def test_prefix_suffix_layer_matches_jax(name, layer):
    """Prefix 16 + suffix 8 against a chunk of 4: the chunk binds."""
    jcfg, cfg, params_np, params = _layer_model(name)
    sliding, rope_on = jcfg.layer_sliding[layer], jcfg.layer_rope[layer]
    rng = np.random.default_rng(20 + layer)
    ph, sh = _x(rng, B, LP, cfg.hidden_size), _x(rng, B, S, LS, cfg.hidden_size)
    p_out, s_out, (kv,) = llama.prefix_suffix_layer(
        [params["layers"][layer]], cfg, _t(ph), _t(sh), _t(PLEN), return_kv=True,
        sliding=sliding, rope_on=rope_on, use_pallas=True)
    jp = jax.tree.map(jnp.asarray, params_np["layers"][layer])
    for b in range(B):
        jpo, jso, jkv = jllama.prefix_suffix_layer(
            jp, jcfg, jnp.asarray(ph[b]), jnp.asarray(sh[b]), jnp.int32(PLEN[b]),
            use_pallas=True, return_kv=True, sliding=sliding, rope_on=rope_on)
        np.testing.assert_allclose(p_out[b, : PLEN[b]].numpy(), np.asarray(jpo)[: PLEN[b]],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(s_out[b].numpy(), np.asarray(jso), atol=ATOL, rtol=0)
        for key in ("kp", "vp", "ks", "vs"):
            np.testing.assert_allclose(kv[key][b].numpy(), np.asarray(jkv[key]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("per_suffix", [False, True], ids=["shared-t", "per-suffix-t"])
@pytest.mark.parametrize("layer", [0, 1, 2], ids=["chunked-dense", "chunked-moe", "nope-dense"])
@pytest.mark.parametrize("name", list(CFGS))
def test_decode_step_layer_matches_jax(name, layer, per_suffix):
    """One new token (the decode kernel's route, per-suffix slots the plain
    op's), the chunk applied, the NoPE layer's temperature at each
    suffix's own position."""
    jcfg, cfg, params_np, params = _layer_model(name)
    sliding, rope_on = jcfg.layer_sliding[layer], jcfg.layer_rope[layer]
    rng = np.random.default_rng(30 + layer)
    nkv, hd = cfg.num_key_value_heads, cfg.head_dim
    x = _x(rng, B, S, 1, cfg.hidden_size)
    kv_np = {"kp": _x(rng, B, LP, nkv, hd), "vp": _x(rng, B, LP, nkv, hd),
             "ks": _x(rng, B, S, LS, nkv, hd), "vs": _x(rng, B, S, LS, nkv, hd),
             "kg": _x(rng, B, S, T, nkv, hd), "vg": _x(rng, B, S, T, nkv, hd)}
    t = np.array([[1, 2], [0, 1]], np.int32) if per_suffix else 1
    kv = {k: _t(v.copy()) for k, v in kv_np.items()}
    out = llama.decode_step_layer([params["layers"][layer]], cfg, _t(x), [kv], _t(PLEN), _t(EOS),
                                  _t(t) if per_suffix else t, sliding=sliding, rope_on=rope_on,
                                  use_pallas=True)
    jp = jax.tree.map(jnp.asarray, params_np["layers"][layer])
    for b in range(B):
        jkv = {k: jnp.asarray(v[b]) for k, v in kv_np.items()}
        jt = jnp.asarray(t[b]) if per_suffix else jnp.int32(t)
        jout, jkv_new = jllama.decode_step_layer(jp, jcfg, jnp.asarray(x[b]), jkv,
                                                 jnp.int32(PLEN[b]), jnp.asarray(EOS[b]), jt,
                                                 sliding=sliding, rope_on=rope_on, use_pallas=True)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jout), atol=ATOL, rtol=0)
        for key in ("kg", "vg"):
            np.testing.assert_allclose(kv[key][b].numpy(), np.asarray(jkv_new[key]), atol=ATOL,
                                       rtol=0)


# ---------------------------------------------------------------------------
# Scout's published config
# ---------------------------------------------------------------------------

def _scout_text() -> dict:
    """meta-llama/Llama-4-Scout-17B-16E's text_config: transformers'
    Llama4TextConfig defaults are its widths, with its published
    rope_scaling (llama3, factor 16, both band factors 1.0)."""
    import transformers as tf

    d = tf.Llama4TextConfig().to_dict()
    d["rope_scaling"] = {"rope_type": "llama3", "factor": 16.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 1.0, "original_max_position_embeddings": 8192}
    return d


@pytest.mark.parametrize("wrapped", [False, True], ids=["text", "wrapper"])
def test_scout_config_matches_jax(wrapped):
    d = _scout_text()
    if wrapped:
        d = {"model_type": "llama4", "text_config": d, "vision_config": {"hidden_size": 1408}}
    cfg, jcfg = LlamaConfig.from_dict(d), JLlamaConfig.from_hf_config(d)
    assert dataclasses.asdict(cfg) == {f.name: getattr(jcfg, f.name)
                                       for f in dataclasses.fields(LlamaConfig)}
    assert (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
            cfg.vocab_size, cfg.num_local_experts, cfg.attention_chunk_size) == (
        5120, 40, 8, 128, 202048, 16, 8192)
    assert cfg.layer_rope[:4] == (True, True, True, False) and cfg.moe_layer_pattern is None
    # Equal band factors: the middle band's division by zero is discarded,
    # bit for bit as in the JAX package.
    spec = cfg.rope_scaling_spec
    assert spec == jcfg.rope_scaling_spec
    with np.errstate(divide="ignore", invalid="ignore"):
        want_freq = jrope._inv_freq(cfg.head_dim, cfg.rope_theta, spec)
    np.testing.assert_array_equal(rope._inv_freq(cfg.head_dim, cfg.rope_theta, spec), want_freq)
    pos = np.arange(0, 9000, 7, dtype=np.int32)
    c, s = rope.rope_cos_sin(_t(pos), cfg.head_dim, cfg.rope_theta, spec)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta, spec)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# transformers checkpoints: the splitters and the CLI
# ---------------------------------------------------------------------------

def _hf_text_config():
    """LLAMA4_CFG as a transformers Llama4TextConfig: layer 1 of 3 the MoE
    (interleave step 2), layers 0-1 chunked (4), layer 2 NoPE."""
    import transformers as tf

    c = LLAMA4_CFG
    return tf.Llama4TextConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size, intermediate_size=c.intermediate_size,
        intermediate_size_mlp=c.intermediate_size_mlp, num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads, num_key_value_heads=c.num_key_value_heads,
        head_dim=c.head_dim, max_position_embeddings=c.max_position_embeddings,
        num_local_experts=c.num_local_experts, num_experts_per_tok=c.num_experts_per_tok,
        interleave_moe_layer_step=2, attention_chunk_size=c.attention_chunk_size,
        layer_types=["chunked_attention" if s else "full_attention" for s in c.layer_sliding],
        no_rope_layers=[int(r) for r in c.layer_rope], use_qk_norm=True,
        attn_temperature_tuning=True, floor_scale=c.attn_floor_scale, attn_scale=c.attn_scale_coef,
        tie_word_embeddings=False, pad_token_id=0)


def hf_llama4(path, wrapped: bool = False, seed: int = 0) -> None:
    """A tiny random transformers Llama 4 saved with ``save_pretrained``:
    the text model, or the multimodal wrapper with a small vision tower;
    every parameter redrawn from ``seed``."""
    import transformers as tf

    text = _hf_text_config()
    if wrapped:
        vision = tf.Llama4VisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                       num_attention_heads=2, image_size=28, patch_size=14,
                                       vision_output_dim=32, projector_input_dim=32,
                                       projector_output_dim=32)
        model = tf.Llama4ForConditionalGeneration(
            tf.Llama4Config(text_config=text.to_dict(), vision_config=vision.to_dict()))
    else:
        model = tf.Llama4ForCausalLM(text)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.3 if p.ndim == 1 else 0.1))
    model.save_pretrained(str(path))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("wrapped", [False, True], ids=["text", "wrapper"])
def test_split_matches_jax_splitter(tmp_path, wrapped, dtype):
    """The feed_forward keys (dense Linears; the fused expert tensors, the
    router and the shared expert) and the wrapper's nested keys: the same
    layer files, tensors bit for bit, and the same config.json."""
    hf_llama4(tmp_path / "hf", wrapped)
    want = jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), dtype=dtype)
    got = checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"), dtype=dtype)
    assert got == want
    _assert_same_split(tmp_path / "port", tmp_path / "jax")
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "port"))
    assert cfg.model_type == "llama4_text" and cfg.moe_layer_pattern == (False, True, False)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_requantize_native_matches_jax(tmp_path, dtype):
    hf_llama4(tmp_path / "hf", seed=1)
    jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "float"), dtype="float32")
    jckpt.requantize_native(str(tmp_path / "float"), str(tmp_path / "jax"), dtype=dtype)
    checkpoint.requantize_native(str(tmp_path / "float"), str(tmp_path / "port"), dtype=dtype)
    _assert_same_split(tmp_path / "port", tmp_path / "jax")


@pytest.fixture(scope="module")
def split_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("llama4_cli")
    hf_llama4(root / "hf", seed=2)
    jckpt.split_into_layers(str(root / "hf"), str(root / "split"), dtype="float32")
    return root / "split"


CLI_MODES = {
    "generation_loop": [],
    "kv_cache": ["--kv_cache", "true"],
    "speculative": ["--kv_cache", "true", "--speculative_k", "2"],
    "resident": ["--kv_cache", "true", "--decode_resident", "on", "--decode_fused", "off"],
    "fused": ["--kv_cache", "true", "--decode_resident", "on", "--decode_fused", "on"],
}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_matches_jax_cli(split_model, tmp_path, mode):
    extra = ["--num_gen_token", "3", *CLI_MODES[mode]]
    want = run_cli(jax_main, split_model, tmp_path, "jax", [*extra, "--num_devices", "1"])
    got = run_cli(torch_main, split_model, tmp_path, "torch", [*extra, "--device", "cpu"])
    assert_cli_match(got, want)
