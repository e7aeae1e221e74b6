"""The PyTorch port's layer functions against the JAX package's, on the same
seeded parameters (converted with ``params_from_jax``) and inputs. The JAX
side runs once on its XLA attention and once on its Pallas kernels in
interpret mode. Float32, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.utils.checkpoint import params_from_jax

ATOL = 1e-5
B, LP, S, LS, T = 2, 64, 2, 64, 3
PLEN = np.array([50, 9], np.int32)
EOS = np.array([[3, 63], [0, 17]], np.int32)


def _model(head_dim: int = 64):
    kw = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2)
    if head_dim != 64:
        kw["explicit_head_dim"] = head_dim
    jcfg = JLlamaConfig(**kw)
    params_np = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = LlamaConfig.from_dict(
        {"fls_native": True, **{k: getattr(jcfg, k) for k in kw}}
    )
    return jcfg, cfg, params_np, params_from_jax(params_np, cfg)


def _h(rng, *shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _real_prefix_rows(a, b):
    return a[b, : PLEN[b]]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefix_suffix_layer_matches_jax(use_pallas):
    jcfg, cfg, params_np, params = _model()
    rng = np.random.default_rng(0)
    ph, sh = _h(rng, B, LP, cfg.hidden_size), _h(rng, B, S, LS, cfg.hidden_size)
    p_out, s_out, kv = llama.prefix_suffix_layer(
        params["layers"][0], cfg, torch.from_numpy(ph), torch.from_numpy(sh),
        torch.from_numpy(PLEN), return_kv=True, use_pallas=use_pallas,
    )
    jp = jax.tree.map(jnp.asarray, params_np["layers"][0])
    for b in range(B):
        jpo, jso, jkv = jllama.prefix_suffix_layer(
            jp, jcfg, jnp.asarray(ph[b]), jnp.asarray(sh[b]), jnp.int32(PLEN[b]),
            use_pallas=use_pallas, return_kv=True,
        )
        # Prefix padding rows are padding in both; the real rows must agree.
        np.testing.assert_allclose(
            p_out[b, : PLEN[b]].numpy(), np.asarray(jpo)[: PLEN[b]], atol=ATOL, rtol=0
        )
        np.testing.assert_allclose(s_out[b].numpy(), np.asarray(jso), atol=ATOL, rtol=0)
        for key in ("kp", "vp", "ks", "vs"):
            np.testing.assert_allclose(kv[key][b].numpy(), np.asarray(jkv[key]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pallas,head_dim", [(False, 64), (True, 128)])
def test_decode_step_layer_matches_jax(use_pallas, head_dim):
    """hd 128 is the Pallas decode kernel's own eligibility."""
    jcfg, cfg, params_np, params = _model(head_dim)
    rng = np.random.default_rng(1)
    nkv, hd = cfg.num_key_value_heads, cfg.head_dim
    x = _h(rng, B, S, 1, cfg.hidden_size)
    kv_np = {
        "kp": _h(rng, B, LP, nkv, hd), "vp": _h(rng, B, LP, nkv, hd),
        "ks": _h(rng, B, S, LS, nkv, hd), "vs": _h(rng, B, S, LS, nkv, hd),
        "kg": _h(rng, B, S, T, nkv, hd), "vg": _h(rng, B, S, T, nkv, hd),
    }
    t = 1
    kv = {k: torch.from_numpy(v.copy()) for k, v in kv_np.items()}
    out = llama.decode_step_layer(
        params["layers"][1], cfg, torch.from_numpy(x), kv, torch.from_numpy(PLEN),
        torch.from_numpy(EOS), t, use_pallas=use_pallas,
    )
    jp = jax.tree.map(jnp.asarray, params_np["layers"][1])
    for b in range(B):
        jkv = {k: jnp.asarray(v[b]) for k, v in kv_np.items()}
        jout, jkv_new = jllama.decode_step_layer(
            jp, jcfg, jnp.asarray(x[b]), jkv, jnp.int32(PLEN[b]), jnp.asarray(EOS[b]),
            jnp.int32(t), use_pallas=use_pallas,
        )
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jout), atol=ATOL, rtol=0)
        for key in ("kg", "vg"):  # slot t written in place, the rest untouched
            np.testing.assert_allclose(kv[key][b].numpy(), np.asarray(jkv_new[key]), atol=ATOL, rtol=0)


def test_norm_and_head_match_jax():
    jcfg, cfg, params_np, params = _model()
    rng = np.random.default_rng(2)
    sh = _h(rng, B, S, LS, cfg.hidden_size)
    h = llama.select_eos_and_norm(params["norm"], cfg, torch.from_numpy(sh), torch.from_numpy(EOS))
    scores = llama.lm_head_scores(llama.head_params(params), h, cfg.final_logit_softcap)
    jnorm = jax.tree.map(jnp.asarray, params_np["norm"])
    jhead = jax.tree.map(jnp.asarray, jllama.head_params(params_np))
    for b in range(B):
        jh = jllama.select_eos_and_norm(jnorm, jcfg, jnp.asarray(sh[b]), jnp.asarray(EOS[b]))
        np.testing.assert_allclose(h[b].numpy(), np.asarray(jh), atol=ATOL, rtol=0)
        js = jllama.lm_head_scores(jhead, jh)
        np.testing.assert_allclose(scores[b].numpy(), np.asarray(js), atol=ATOL, rtol=0)
    np.testing.assert_allclose(scores.sum(-1).numpy(), 1.0, atol=1e-5)


def test_tied_head_and_embed_match_jax():
    jcfg, cfg, params_np, params = _model()
    params_np = dict(params_np)
    params_np.pop("lm_head")
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, 5)).astype(np.int32)
    got = llama.embed(params["embed"], torch.from_numpy(ids), torch.float32)
    want = jllama.embed(jax.tree.map(jnp.asarray, params_np["embed"]), jnp.asarray(ids), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    params.pop("lm_head")
    np.testing.assert_array_equal(
        llama.head_params(params)["kernel"].numpy(),
        np.asarray(jllama.head_params(params_np)["kernel"]),
    )
