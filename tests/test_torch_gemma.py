"""The port's Gemma 2 / Gemma 3 machinery against the JAX package's, on the
CPU in float32: config parsing and native round trips, the (1+w) RMSNorm,
the per-layer rope base with linear scaling, the layer functions for a
local and a global layer (random norm and q/k-norm scales, which the JAX
init leaves at ones), and the batch CLI against the JAX CLI on tiny
checkpoints whose sliding windows bind. Layers and ops within atol 1e-5;
CLI scores within atol 1e-5 / rtol 1e-4 with identical updated prompts."""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu.cli import main as jax_main
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.ops.norm import rms_norm as j_rms_norm
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.cli import main as torch_main
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.utils import checkpoint

ATOL = 1e-5
PORT_FIELDS = [f.name for f in dataclasses.fields(LlamaConfig)]

# The text_config of google/gemma-3-27b-pt's config.json (the fields that
# shape the model), and a Gemma-2-9B-shaped HF config.
GEMMA3_27B_TEXT = {
    "model_type": "gemma3_text", "hidden_size": 5376, "intermediate_size": 21504,
    "num_hidden_layers": 62, "num_attention_heads": 32, "num_key_value_heads": 16,
    "head_dim": 128, "vocab_size": 262208, "rms_norm_eps": 1e-6,
    "query_pre_attn_scalar": 168, "sliding_window": 1024, "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0, "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
    "hidden_activation": "gelu_pytorch_tanh", "max_position_embeddings": 131072,
    "final_logit_softcapping": None, "attn_logit_softcapping": None,
}
GEMMA2_9B = {
    "model_type": "gemma2", "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16, "num_key_value_heads": 8,
    "head_dim": 256, "vocab_size": 256000, "rms_norm_eps": 1e-6, "query_pre_attn_scalar": 256,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh",
}
HF_CONFIGS = {
    "gemma3_text": GEMMA3_27B_TEXT,
    "gemma3_wrapper": {"model_type": "gemma3", "text_config": dict(GEMMA3_27B_TEXT)},
    "gemma3_layer_types": {**GEMMA3_27B_TEXT, "num_hidden_layers": 4,
                           "layer_types": ["sliding_attention", "full_attention"] * 2},
    "gemma3_all_local": {**GEMMA3_27B_TEXT, "num_hidden_layers": 5},
    "gemma2": GEMMA2_9B,
    "gemma2_defaults": {"model_type": "gemma2", "num_hidden_layers": 4, "hidden_size": 256,
                        "num_attention_heads": 4, "num_key_value_heads": 2},
}


def _port_view(jcfg: JLlamaConfig) -> dict:
    return {k: getattr(jcfg, k) for k in PORT_FIELDS}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_hf_config_matches_jax(name):
    d = HF_CONFIGS[name]
    cfg = LlamaConfig.from_dict(json.loads(json.dumps(d)))
    assert dataclasses.asdict(cfg) == _port_view(JLlamaConfig.from_hf_config(d))
    assert cfg.head_dim == JLlamaConfig.from_hf_config(d).head_dim


def test_gemma3_27b_config_reads_as_published():
    cfg = LlamaConfig.from_dict(HF_CONFIGS["gemma3_wrapper"])
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, cfg.vocab_size) == (
        5376, 21504, 128, 262208)
    assert cfg.sliding_window == 1024 and cfg.attn_scale == 168**-0.5
    assert cfg.rope_scaling_spec == ("linear", 8.0) and cfg.rope_local_theta == 10000.0
    assert cfg.layer_sliding == tuple((i + 1) % 6 != 0 for i in range(62))
    assert cfg.tie_word_embeddings and cfg.qk_norm and cfg.ffw_sandwich_norms


@pytest.mark.parametrize("d", [
    {"model_type": "mistral", "fls_native": True, "qk_norm": True},
    {"model_type": "qwen2", "rope_scaling": {"type": "yarn", "factor": 4.0,
                                             "original_max_position_embeddings": 32768}},
    {"model_type": "qwen3", "fls_native": True, "ffw_sandwich_norms": True},
    {**GEMMA3_27B_TEXT, "rope_scaling": {"rope_type": "yarn", "factor": 8.0}},
    {"model_type": "llama", "fls_native": True, "qk_norm": True},
], ids=["mistral", "qwen2", "qwen3", "gemma3-yarn", "llama-qk-norm"])
def test_unported_families_raise(d):
    """What the port does not carry: a delta a native config's family lacks.
    The yarn cases (Qwen2.5's scaling), which the port now runs, read as the
    JAX package reads them."""
    if "rope_scaling" in d:
        cfg = LlamaConfig.from_dict(json.loads(json.dumps(d)))
        jcfg = JLlamaConfig.from_hf_config(d)
        assert dataclasses.asdict(cfg) == _port_view(jcfg)
        assert cfg.rope_scaling_spec == jcfg.rope_scaling_spec and cfg.rope_scaling_kind == "yarn"
        return
    with pytest.raises(NotImplementedError):
        LlamaConfig.from_dict(d)


# Tiny Gemma configs whose windows bind at the test lengths: the JAX
# package's GEMMA2_CFG / GEMMA3_CFG shapes (tests/test_model_families.py).
def _gemma3_cfg(**kw) -> JLlamaConfig:
    base = dict(
        model_type="gemma3_text", vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-6, tie_word_embeddings=True,
        explicit_head_dim=32, hidden_act="gelu_pytorch_tanh", norm_unit_offset=True,
        embed_scale=True, ffw_sandwich_norms=True, qk_norm=True, query_pre_attn_scalar=64,
        sliding_window=6, layer_sliding=(True, True, False), rope_theta=1_000_000.0,
        rope_scaling_kind="linear", rope_scaling_factor=2.0, rope_local_theta=10_000.0,
    )
    return JLlamaConfig(**{**base, **kw})


def _gemma2_cfg(**kw) -> JLlamaConfig:
    base = dict(
        model_type="gemma2", vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-6, tie_word_embeddings=True,
        explicit_head_dim=32, hidden_act="gelu_pytorch_tanh", norm_unit_offset=True,
        embed_scale=True, ffw_sandwich_norms=True, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, query_pre_attn_scalar=64, sliding_window=6,
        layer_sliding=(True, False, True),
    )
    return JLlamaConfig(**{**base, **kw})


def _random_norms(params_np: dict, seed: int) -> dict:
    """Every norm and q/k-norm scale redrawn around 0 (the (1+w) form's
    neutral value), so the unit offset and each norm's placement show."""
    rng = np.random.default_rng(seed)

    def redraw(tree):
        if isinstance(tree, dict):
            return {k: (rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
                        if k in ("scale", "q_norm", "k_norm") else redraw(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [redraw(v) for v in tree]
        return tree

    return redraw(params_np)


def _params(jcfg: JLlamaConfig, seed: int) -> dict:
    return _random_norms(jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), jcfg)),
                         seed)


@pytest.mark.parametrize("make", [_gemma3_cfg, _gemma2_cfg], ids=["gemma3", "gemma2"])
def test_native_config_and_gemma_keys_round_trip(tmp_path, make):
    """JAX save_params -> the port reads config and every Gemma key
    (pre/post_feedforward_layernorm, attn.q_norm/k_norm, the tied head with
    no lm_head file) bit for bit; the port's save_params -> JAX reads the
    same config and values back."""
    jcfg = make()
    params_np = _params(jcfg, 3)
    jckpt.save_params(params_np, str(tmp_path / "jax"), jcfg)
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "jax"))
    assert dataclasses.asdict(cfg) == _port_view(jcfg)
    assert not (tmp_path / "jax" / "lm_head.safetensors").exists()
    layer = checkpoint.load_layer(str(tmp_path / "jax"), "model.layers.0")
    keys = set(dict(checkpoint.flatten(layer)))
    assert {"pre_feedforward_layernorm.scale", "post_feedforward_layernorm.scale"} <= keys
    assert ({"attn.q_norm", "attn.k_norm"} <= keys) == jcfg.qk_norm
    params = checkpoint.params_from_jax(params_np, cfg)
    checkpoint.save_params(params, str(tmp_path / "port"), cfg)
    assert JLlamaConfig.from_pretrained(str(tmp_path / "port")) == jcfg
    for i in range(jcfg.num_hidden_layers):
        name = f"model.layers.{i}"
        got = dict(checkpoint.flatten(jckpt.load_layer(str(tmp_path / "port"), name)))
        want = dict(checkpoint.flatten(params_np["layers"][i]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    head = llama.head_params(checkpoint.params_from_jax(params_np, cfg))["kernel"]
    np.testing.assert_array_equal(head.numpy(), np.asarray(jllama.head_params(params_np)["kernel"]))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm_unit_offset_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32) * 3
    scale = rng.standard_normal(128).astype(np.float32) * 0.3
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    want = np.asarray(j_rms_norm(jx, jnp.asarray(scale), 1e-6, unit_offset=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.float32 if dtype is np.float32 else torch.bfloat16)
    got = rms_norm(tx, torch.from_numpy(scale), 1e-6, unit_offset=True).float().numpy()
    # bfloat16: within one bf16 step (the float32 variance may round differently).
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0 if dtype is np.float32 else 2**-7)


@pytest.mark.parametrize("sliding", [True, False, None], ids=["local", "global", "uniform"])
def test_rope_for_layer_matches_jax(sliding):
    """Local layers: the unscaled local base; global layers: rope_theta with
    linear scaling (x8, as Gemma-3-27B)."""
    jcfg = _gemma3_cfg(explicit_head_dim=128, rope_scaling_factor=8.0)
    cfg = LlamaConfig.from_dict({**dataclasses.asdict(jcfg), "fls_native": True})
    pos = np.random.default_rng(1).integers(0, 5000, size=(2, 7)).astype(np.int32)
    jc, js = jllama.rope_for_layer(jcfg, jnp.asarray(pos), sliding)
    c, s = llama.rope_for_layer(cfg, torch.from_numpy(pos), sliding)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL, rtol=0)


# Layer functions: Gemma-3-27B's head layout (hd 128, GQA 2:1, scale 168)
# at a tiny width, a window of 24 that binds at Lp 64 + Ls 64.
B, LP, S, LS, T = 2, 64, 2, 64, 3
PLEN = np.array([50, 9], np.int32)
EOS = np.array([[3, 63], [0, 17]], np.int32)


def _layer_model():
    jcfg = _gemma3_cfg(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_hidden_layers=2, explicit_head_dim=128, query_pre_attn_scalar=168,
                       sliding_window=24, layer_sliding=(True, False), rope_scaling_factor=8.0)
    params_np = _params(jcfg, 0)
    cfg = LlamaConfig.from_dict({**dataclasses.asdict(jcfg), "fls_native": True})
    return jcfg, cfg, params_np, checkpoint.params_from_jax(params_np, cfg)


def _h(rng, *shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("layer", [0, 1], ids=["local", "global"])
def test_prefix_suffix_layer_matches_jax(layer, use_pallas):
    jcfg, cfg, params_np, params = _layer_model()
    sliding = jllama.layer_sliding_pattern(jcfg)[layer]
    rng = np.random.default_rng(10 + layer)
    ph, sh = _h(rng, B, LP, cfg.hidden_size), _h(rng, B, S, LS, cfg.hidden_size)
    p_out, s_out, kv = llama.prefix_suffix_layer(
        params["layers"][layer], cfg, torch.from_numpy(ph), torch.from_numpy(sh),
        torch.from_numpy(PLEN), return_kv=True, sliding=sliding,
    )
    jp = jax.tree.map(jnp.asarray, params_np["layers"][layer])
    for b in range(B):
        jpo, jso, jkv = jllama.prefix_suffix_layer(
            jp, jcfg, jnp.asarray(ph[b]), jnp.asarray(sh[b]), jnp.int32(PLEN[b]),
            use_pallas=use_pallas, return_kv=True, sliding=sliding,
        )
        np.testing.assert_allclose(p_out[b, : PLEN[b]].numpy(), np.asarray(jpo)[: PLEN[b]],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(s_out[b].numpy(), np.asarray(jso), atol=ATOL, rtol=0)
        for key in ("kp", "vp", "ks", "vs"):
            np.testing.assert_allclose(kv[key][b].numpy(), np.asarray(jkv[key]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("layer", [0, 1], ids=["local", "global"])
def test_decode_step_layer_matches_jax(layer, use_pallas):
    jcfg, cfg, params_np, params = _layer_model()
    sliding = jllama.layer_sliding_pattern(jcfg)[layer]
    rng = np.random.default_rng(20 + layer)
    nkv, hd = cfg.num_key_value_heads, cfg.head_dim
    x = _h(rng, B, S, 1, cfg.hidden_size)
    kv_np = {
        "kp": _h(rng, B, LP, nkv, hd), "vp": _h(rng, B, LP, nkv, hd),
        "ks": _h(rng, B, S, LS, nkv, hd), "vs": _h(rng, B, S, LS, nkv, hd),
        "kg": _h(rng, B, S, T, nkv, hd), "vg": _h(rng, B, S, T, nkv, hd),
    }
    t = 2
    kv = {k: torch.from_numpy(v.copy()) for k, v in kv_np.items()}
    out = llama.decode_step_layer(
        params["layers"][layer], cfg, torch.from_numpy(x), kv, torch.from_numpy(PLEN),
        torch.from_numpy(EOS), t, sliding=sliding,
    )
    jp = jax.tree.map(jnp.asarray, params_np["layers"][layer])
    for b in range(B):
        jkv = {k: jnp.asarray(v[b]) for k, v in kv_np.items()}
        jout, jkv_new = jllama.decode_step_layer(
            jp, jcfg, jnp.asarray(x[b]), jkv, jnp.int32(PLEN[b]), jnp.asarray(EOS[b]),
            jnp.int32(t), sliding=sliding, use_pallas=use_pallas,
        )
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jout), atol=ATOL, rtol=0)
        for key in ("kg", "vg"):
            np.testing.assert_allclose(kv[key][b].numpy(), np.asarray(jkv_new[key]), atol=ATOL, rtol=0)


def test_embed_and_final_norm_match_jax():
    jcfg, cfg, params_np, params = _layer_model()
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(B, 5)).astype(np.int32)
    got = llama.embed(params["embed"], torch.from_numpy(ids), torch.float32, cfg)
    want = jllama.embed(jax.tree.map(jnp.asarray, params_np["embed"]), jnp.asarray(ids),
                        jnp.float32, jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sh = _h(np.random.default_rng(5), B, S, LS, cfg.hidden_size)
    h = llama.select_eos_and_norm(params["norm"], cfg, torch.from_numpy(sh), torch.from_numpy(EOS))
    jnorm = jax.tree.map(jnp.asarray, params_np["norm"])
    for b in range(B):
        jh = jllama.select_eos_and_norm(jnorm, jcfg, jnp.asarray(sh[b]), jnp.asarray(EOS[b]))
        np.testing.assert_allclose(h[b].numpy(), np.asarray(jh), atol=ATOL, rtol=0)


# The batch CLI against the JAX CLI on tiny checkpoints.
class SmallVocabTokenizer(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the quick brown fox jumps over the lazy dog " * 3, (" and runs", " then sleeps all day")),
    ("a b c d e", (" f",)),
    ("one two three four five six seven eight nine ten eleven twelve",
     (" thirteen fourteen", " x", " y z")),
    ("lorem ipsum dolor sit amet", (" consectetur", " adipiscing elit sed")),
]


def _run(main, model_dir, tmp_path, tag, extra):
    ppkl, opkl = tmp_path / f"{tag}.pkl", tmp_path / f"{tag}_scores.pkl"
    ppkl.write_bytes(pickle.dumps(PROMPTS))
    main(["--model_path", model_dir, "--prompt_pickle", str(ppkl), "--output_file", str(opkl),
          "--dtype", "float32", "--bucket_multiple", "16", "--block_size", "2",
          "--disk_folder", str(tmp_path / f"{tag}_disk"), *extra],
         tokenizer=SmallVocabTokenizer())
    scores = pickle.loads(opkl.read_bytes())
    updated = pickle.loads((tmp_path / f"{tag}_updated.pkl").read_bytes())
    return scores, updated


@pytest.mark.parametrize("mode", [[], ["--kv_cache", "true"]], ids=["generation_loop", "kv_cache"])
@pytest.mark.parametrize("make", [_gemma3_cfg, _gemma2_cfg], ids=["gemma3", "gemma2"])
def test_cli_matches_jax_cli(tmp_path, make, mode):
    jcfg = make()
    d = str(tmp_path / "model")
    jckpt.save_params(_params(jcfg, 7), d, jcfg)
    extra = ["--num_gen_token", "3", *mode]
    want, want_up = _run(jax_main, d, tmp_path, "jax", [*extra, "--num_devices", "1"])
    got, got_up = _run(torch_main, d, tmp_path, "torch", [*extra, "--device", "cpu"])
    for g, w, (_, sfx) in zip(got, want, PROMPTS):
        assert g.shape == w.shape == (len(sfx), 3, jcfg.vocab_size)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    assert got_up == want_up
