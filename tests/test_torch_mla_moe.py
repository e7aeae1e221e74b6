"""DeepSeek's multi-head latent attention and the mixture-of-experts MLPs
of the port against the JAX package's, on the CPU in float32, from the same
seeded numpy inputs: ``_qkv_mla`` with and without q LoRA; DeepSeek's MoE
with one group and with group-limited routing under a negative correction
bias; the Mixtral/Qwen3-MoE MoE with and without renormalisation, and
unselected experts adding exactly nothing; the plain scoring ops at MLA's
(qk 192, v 128) against the Pallas kernels in interpret mode, with a window,
a chunk, the toggle off and a softcap; a DeepSeek layer (MLA, experts)
through the prefix/suffix and decode layer functions; what the CUDA
wrappers accept; and the batch CLI against the JAX CLI on tiny transformers
checkpoints of deepseek_v3 (q LoRA on, and a dense q), mixtral and
qwen3_moe, split by each package's splitter, in the re-scoring loop and
with --kv_cache. Everything within atol 1e-5, CLI tokens identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu.cli import main as jax_main
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.ops import pallas_attention as jpallas
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch.cli import main as torch_main
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
from flexible_llm_sharding_tpu_torch.utils import checkpoint
from tests.test_torch_checkpoint import (
    HF_MOE_FAMILIES,
    _assert_same_split,
    assert_cli_match,
    hf_checkpoint,
    run_cli,
)

ATOL = 1e-5


def _deepseek_cfg(**kw) -> JLlamaConfig:
    """A tiny DeepSeek-V3: MLA (qk 16 + 8, v 12, q LoRA 24, KV latent 16),
    yarn with the mscale pair, layer 0 dense and layer 1 with 8 experts in 4
    groups (the best 2 kept), 2 per token, a shared expert."""
    d = {
        "model_type": "deepseek_v3", "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "moe_intermediate_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 4, "n_routed_experts": 8, "num_experts_per_tok": 2, "n_group": 4,
        "topk_group": 2, "first_k_dense_replace": 1, "routed_scaling_factor": 2.5,
        "kv_lora_rank": 16, "q_lora_rank": 24, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 12, "max_position_embeddings": 512, "rope_scaling": {
            "type": "yarn", "factor": 4.0, "mscale": 1.0, "mscale_all_dim": 1.0,
            "original_max_position_embeddings": 32, "beta_fast": 32, "beta_slow": 1},
    }
    return JLlamaConfig.from_hf_config({**d, **kw})


def _port(jcfg: JLlamaConfig) -> LlamaConfig:
    return LlamaConfig.from_dict({**dataclasses.asdict(jcfg), "fls_native": True})


def _redraw(tree, rng):
    """Every norm scale redrawn around 1 and every correction bias around
    -0.3 (mostly negative: the group mask's 0.0 then beats eligible
    experts, as in HF), so their placement shows."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("scale", "q_a_norm", "kv_a_norm"):
                out[k] = (1.0 + rng.normal(0, 0.3, np.shape(v))).astype(np.float32)
            elif k == "correction_bias":
                out[k] = rng.normal(-0.3, 0.4, np.shape(v)).astype(np.float32)
            else:
                out[k] = _redraw(v, rng)
        return out
    if isinstance(tree, list):
        return [_redraw(v, rng) for v in tree]
    return np.array(tree)


def _params(jcfg: JLlamaConfig, seed: int) -> dict:
    init = jllama.init_mixed_params if jcfg.moe_layer_pattern is not None else jllama.init_params
    return _redraw(jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg)),
                   np.random.default_rng(seed))


def _x(rng, *shape):
    return (rng.standard_normal(shape) * 0.7).astype(np.float32)


# ---------------------------------------------------------------------------
# MLA's q/k/v and the MoE MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "half-split"])
@pytest.mark.parametrize("q_lora", [24, None], ids=["q-lora", "dense-q"])
def test_qkv_mla_matches_jax(q_lora, interleaved):
    jcfg = _deepseek_cfg(q_lora_rank=q_lora, rope_interleave=interleaved, attention_bias=True)
    cfg = _port(jcfg)
    assert (cfg.head_dim, cfg.v_dim, cfg.rope_interleaved) == (24, 12, interleaved)
    attn = _params(jcfg, 1)["layers"][0]["attn"]
    assert ("q_a" in attn) == bool(q_lora) and "bkv_a" in attn
    rng = np.random.default_rng(2)
    x = _x(rng, 2, 5, 64)
    pos = rng.integers(0, 200, size=(2, 5)).astype(np.int32)
    q, k, v = llama._qkv_mla({k: torch.from_numpy(a) for k, a in attn.items()}, cfg,
                             torch.from_numpy(x), torch.from_numpy(pos))
    jq, jk, jv = jllama._qkv_mla(jax.tree.map(jnp.asarray, attn), jcfg, jnp.asarray(x),
                                 jnp.asarray(pos))
    assert tuple(q.shape) == (2, 5, 4, 24) and tuple(v.shape) == (2, 5, 4, 12)
    assert v.is_contiguous()
    for got, want in ((q, jq), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("norm", [True, False], ids=["renormalised", "raw"])
@pytest.mark.parametrize("groups", [(1, 1), (4, 2), (2, 1)], ids=["one-group", "4-groups-top2",
                                                                   "2-groups-top1"])
def test_deepseek_moe_matches_jax(groups, norm):
    n_group, topk_group = groups
    jcfg = _deepseek_cfg(n_group=n_group, topk_group=topk_group, norm_topk_prob=norm)
    cfg = _port(jcfg)
    mlp = _params(jcfg, 3)["layers"][1]["mlp"]
    assert mlp["correction_bias"].min() < 0 < mlp["correction_bias"].max()
    x = _x(np.random.default_rng(4), 3, 6, 64)
    got = llama._mlp({k: torch.from_numpy(v) for k, v in mlp.items()}, cfg, torch.from_numpy(x))
    want = jllama._mlp(jax.tree.map(jnp.asarray, mlp), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _mixtral_cfg(**kw) -> JLlamaConfig:
    return JLlamaConfig(**{"model_type": "mixtral", "vocab_size": 256, "hidden_size": 64,
                           "intermediate_size": 48, "num_hidden_layers": 1,
                           "num_attention_heads": 4, "num_key_value_heads": 2,
                           "num_local_experts": 6, "num_experts_per_tok": 2, **kw})


@pytest.mark.parametrize("norm", [True, False], ids=["mixtral", "qwen3_moe-raw"])
def test_moe_mlp_matches_jax(norm):
    jcfg = _mixtral_cfg(moe_norm_topk_prob=norm, num_experts_per_tok=3)
    cfg = _port(jcfg)
    mlp = _params(jcfg, 5)["layers"][0]["mlp"]
    x = _x(np.random.default_rng(6), 2, 7, 64)
    got = llama._mlp({k: torch.from_numpy(v) for k, v in mlp.items()}, cfg, torch.from_numpy(x))
    want = jllama._mlp(jax.tree.map(jnp.asarray, mlp), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_unselected_experts_add_exactly_nothing():
    """An expert no token selects never runs: an overflow in its weights
    reaches no output (the JAX package's where(c != 0, ...) hard zero; a
    compute-all h * 0 would give NaN)."""
    jcfg = _mixtral_cfg()
    cfg = _port(jcfg)
    mlp = {k: torch.from_numpy(v) for k, v in _params(jcfg, 7)["layers"][0]["mlp"].items()}
    x = torch.from_numpy(_x(np.random.default_rng(8), 1, 2, 64))  # 4 choices of 6 experts
    probs = torch.softmax(x @ mlp["router"], dim=-1)
    chosen = set(llama._top_k(probs, 2)[1].flatten().tolist())
    unused = [e for e in range(6) if e not in chosen]
    assert unused, "every expert was selected: pick another seed"
    base = llama._mlp(mlp, cfg, x)
    mlp["up"][unused[0]] = float("inf")
    out = llama._mlp(mlp, cfg, x)
    assert torch.isfinite(out).all()
    assert torch.equal(out, base)


def test_top_k_breaks_ties_to_the_lower_index():
    x = torch.tensor([[0.0, 0.5, 0.0, 0.5, -1.0, 0.0]])
    vals, idx = llama._top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 3, 0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# The scoring ops at MLA's head dims, against the Pallas kernels
# ---------------------------------------------------------------------------

B, NQ, LP, S, LS = 2, 4, 128, 2, 64
PLEN = np.array([100, 37], np.int32)
FORMS = [({}, "plain"), ({"window": 48}, "window48"), ({"chunk": 32}, "chunk32"),
         ({"window": 48, "local_on": False}, "window48-off"), ({"softcap": 30.0}, "softcap30")]


def _jax_kw(kw):
    return {k: jnp.asarray(v) if k == "local_on" else v for k, v in kw.items()}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("kw", [f for f, _ in FORMS], ids=[n for _, n in FORMS])
def test_causal_plain_at_mla_dims_matches_pallas(kw):
    rng = np.random.default_rng(11)
    q, k, v = _x(rng, B, LP, NQ, 192), _x(rng, B, LP, NQ, 192), _x(rng, B, LP, NQ, 128)
    got = fa.flash_causal_attention(_t(q), _t(k), _t(v), _t(PLEN), **kw).numpy()
    assert got.shape == (B, LP, NQ, 128)
    for b in range(B):
        pal = jpallas.flash_causal_attention(jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]),
                                             jnp.int32(PLEN[b]), interpret=True, **_jax_kw(kw))
        assert pal.shape == (LP, NQ, 128)
        # Padding rows past a window see no key: 0 here, another value in Pallas.
        i, j = np.arange(LP)[:, None], np.arange(LP)[None, :]
        seen = (j <= i) & (j < PLEN[b])
        if kw.get("local_on") is not False and "window" in kw:
            seen &= i - j < kw["window"]
        if "chunk" in kw:
            seen &= i // kw["chunk"] == j // kw["chunk"]
        rows = seen.any(-1)
        np.testing.assert_allclose(got[b][rows], np.asarray(pal)[rows], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [f for f, _ in FORMS], ids=[n for _, n in FORMS])
def test_prefix_shared_plain_at_mla_dims_matches_pallas(kw):
    rng = np.random.default_rng(12)
    q = _x(rng, B, S, LS, NQ, 192)
    kp, vp = _x(rng, B, LP, NQ, 192), _x(rng, B, LP, NQ, 128)
    ks, vs = _x(rng, B, S, LS, NQ, 192), _x(rng, B, S, LS, NQ, 128)
    got = fa.flash_prefix_shared_attention(_t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(PLEN),
                                           **kw).numpy()
    assert got.shape == (B, S, LS, NQ, 128)
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (q, kp, vp, ks, vs)]
        pal = jpallas.flash_prefix_shared_attention(*args, jnp.int32(PLEN[b]), interpret=True,
                                                    **_jax_kw(kw))
        np.testing.assert_allclose(got[b], np.asarray(pal), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dims,decode,ok", [
    ((192, 128), False, True), ((192, 128), True, False), ((192, 192), False, False),
    ((128, 64), False, False), ((128, 128), True, True), ((96, 96), False, True),
], ids=["mla-scoring", "mla-decode", "192-192", "128-64", "128-decode", "96"])
def test_cuda_wrappers_take_mla_dims_only_in_scoring(dims, decode, ok):
    hd, hd_v = dims
    if ok:
        fa.check_cuda_args(head_dim=hd, v_dim=hd_v, decode=decode)
    else:
        with pytest.raises(NotImplementedError):
            fa.check_cuda_args(head_dim=hd, v_dim=hd_v, decode=decode)


# ---------------------------------------------------------------------------
# A DeepSeek layer through the layer functions
# ---------------------------------------------------------------------------

LPL, LSL, T = 16, 8, 3
PLEN_L = np.array([13, 5], np.int32)
EOS = np.array([[2, 7], [0, 4]], np.int32)


def _layer_model():
    jcfg = _deepseek_cfg()
    params_np = _params(jcfg, 9)
    cfg = _port(jcfg)
    return jcfg, cfg, params_np, checkpoint.params_from_jax(params_np, cfg)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("layer", [0, 1], ids=["dense", "moe"])
def test_mla_prefix_suffix_layer_matches_jax(layer, use_pallas):
    jcfg, cfg, params_np, params = _layer_model()
    rng = np.random.default_rng(20 + layer)
    ph, sh = _x(rng, B, LPL, 64), _x(rng, B, S, LSL, 64)
    p_out, s_out, kv = llama.prefix_suffix_layer(
        params["layers"][layer], cfg, _t(ph), _t(sh), _t(PLEN_L), return_kv=True)
    assert tuple(kv["vp"].shape) == (B, LPL, 4, 12) and tuple(kv["kp"].shape) == (B, LPL, 4, 24)
    jp = jax.tree.map(jnp.asarray, params_np["layers"][layer])
    for b in range(B):
        jpo, jso, jkv = jllama.prefix_suffix_layer(
            jp, jcfg, jnp.asarray(ph[b]), jnp.asarray(sh[b]), jnp.int32(PLEN_L[b]),
            use_pallas=use_pallas, return_kv=True)
        np.testing.assert_allclose(p_out[b, : PLEN_L[b]].numpy(), np.asarray(jpo)[: PLEN_L[b]],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(s_out[b].numpy(), np.asarray(jso), atol=ATOL, rtol=0)
        for key in ("kp", "vp", "ks", "vs"):
            np.testing.assert_allclose(kv[key][b].numpy(), np.asarray(jkv[key]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("layer", [0, 1], ids=["dense", "moe"])
def test_mla_decode_step_layer_matches_jax(layer):
    """MLA decode (the plain op, on both sides), with K at 24 and V at 12."""
    jcfg, cfg, params_np, params = _layer_model()
    rng = np.random.default_rng(30 + layer)
    x = _x(rng, B, S, 1, 64)
    kv_np = {"kp": _x(rng, B, LPL, 4, 24), "vp": _x(rng, B, LPL, 4, 12),
             "ks": _x(rng, B, S, LSL, 4, 24), "vs": _x(rng, B, S, LSL, 4, 12),
             "kg": _x(rng, B, S, T, 4, 24), "vg": _x(rng, B, S, T, 4, 12)}
    t = 1
    kv = {k: torch.from_numpy(v.copy()) for k, v in kv_np.items()}
    out = llama.decode_step_layer(params["layers"][layer], cfg, _t(x), kv, _t(PLEN_L), _t(EOS), t)
    jp = jax.tree.map(jnp.asarray, params_np["layers"][layer])
    for b in range(B):
        jkv = {k: jnp.asarray(v[b]) for k, v in kv_np.items()}
        jout, jkv_new = jllama.decode_step_layer(jp, jcfg, jnp.asarray(x[b]), jkv, jnp.int32(PLEN_L[b]),
                                                 jnp.asarray(EOS[b]), jnp.int32(t), use_pallas=True)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jout), atol=ATOL, rtol=0)
        for key in ("kg", "vg"):
            np.testing.assert_allclose(kv[key][b].numpy(), np.asarray(jkv_new[key]), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The CLI on transformers checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [[], ["--kv_cache", "true"]], ids=["generation_loop", "kv_cache"])
@pytest.mark.parametrize("family", HF_MOE_FAMILIES)
def test_moe_cli_matches_jax_cli(tmp_path, family, mode):
    """Each package's splitter on the same transformers checkpoint (the
    experts stacked, DeepSeek's correction bias of both signs) writes the
    same files; the port's CLI on its split gives the JAX CLI's scores and
    tokens on the JAX split. Both deepseek_v3 checkpoints have a dense
    layer 0 and an MoE layer 1."""
    hf_checkpoint(family, tmp_path / "hf", seed=2)
    checkpoint.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "port"), dtype="float32")
    jckpt.split_into_layers(str(tmp_path / "hf"), str(tmp_path / "jax"), dtype="float32")
    _assert_same_split(tmp_path / "port", tmp_path / "jax")
    cfg = LlamaConfig.from_pretrained(str(tmp_path / "port"))
    assert cfg.num_local_experts > 0
    assert bool(cfg.kv_lora_rank) == family.startswith("deepseek")
    extra = ["--num_gen_token", "3", *mode]
    want = run_cli(jax_main, tmp_path / "jax", tmp_path, "jax", [*extra, "--num_devices", "1"])
    got = run_cli(torch_main, tmp_path / "port", tmp_path, "torch", [*extra, "--device", "cpu"])
    assert_cli_match(got, want)
