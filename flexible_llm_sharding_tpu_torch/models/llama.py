"""Decoder layer functions for the streamed scorer, in PyTorch.

The port of the JAX package's ``models/llama.py`` on one device, for the
families the config carries (Llama, Mistral, Phi-3 once its fused
projections are split, Qwen2's q/k/v biases, Qwen3's q/k norm, the Gemma
1/2/3 deltas, the Mixtral/Qwen3-MoE and DeepSeek experts, and DeepSeek's
multi-head latent attention), all through the same flags. Layers are plain
functions over parameter dictionaries, so streaming a layer is passing
another dictionary. The layout and key names are the JAX package's (linear
kernels stored [in, out]), so a checkpoint reads the same in both packages:

    layer = {
      'input_layernorm': {'scale': [D]},
      'post_attention_layernorm': {'scale': [D]},
      'attn': {'wq': [D, nq*hd], 'wk': [D, nkv*hd], 'wv': [D, nkv*hd],
               'wo': [nq*hd, D], optional 'bq', 'bk', 'bv', 'bo',
               optional 'q_norm', 'k_norm': [hd]},
      'mlp':  {'gate': [D, F], 'up': [D, F], 'down': [F, D],
               optional 'bgate', 'bup', 'bdown'},
      with ffw_sandwich_norms: 'pre_feedforward_layernorm',
               'post_feedforward_layernorm': {'scale': [D]},
    }

An MoE layer's 'mlp' holds 'router' [D, E] and the experts stacked as
'gate'/'up' [E, D, F] and 'down' [E, F, D]; DeepSeek's adds
'correction_bias' [E] and the shared expert 'shared_gate'/'shared_up'
[D, Fs], 'shared_down' [Fs, D]. An MLA layer's 'attn' holds 'wq'
[D, nq*(dn+dr)] or the q LoRA 'q_a' [D, r_q], 'q_a_norm' [r_q], 'q_b'
[r_q, nq*(dn+dr)]; 'kv_a' [D, r_kv+dr], 'kv_a_norm' [r_kv], 'kv_b'
[r_kv, nq*(dn+dv)] and 'wo' [nq*dv, D].

Every function takes an explicit leading block dimension ``B`` (the JAX
package adds it with ``jax.vmap``), with per-prompt ``prefix_len [B]`` and
``suffix_eos [B, S]``. ``sliding`` is the layer's entry of
:func:`layer_sliding_pattern` (a Python bool; None for uniform configs): it
picks the layer's rope base and whether the sliding window applies.
Attention goes through the kernel wrappers of ``ops/flash_attention.py``:
the CUDA kernels on the card, their plain versions on the CPU. The
projections stay ``torch.matmul``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from flexible_llm_sharding_tpu_torch.config import ACTIVATIONS, LlamaConfig
from flexible_llm_sharding_tpu_torch.ops.attention import decode_attention
from flexible_llm_sharding_tpu_torch.ops.flash_attention import (
    flash_causal_attention,
    flash_decode_attention,
    flash_prefix_shared_attention,
)
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.ops.rope import (
    apply_rope,
    apply_rope_interleaved,
    rope_cos_sin,
)

Params = dict[str, Any]

# MLP gate activations by config.hidden_act: HF's 'gelu' is the exact erf
# form, 'gelu_pytorch_tanh' (Gemma) the tanh approximation.
_ACT = {
    "silu": F.silu,
    "gelu": F.gelu,
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}
assert set(_ACT) == set(ACTIVATIONS)


def _lin(x: torch.Tensor, params: Params, w: str, b: str) -> torch.Tensor:
    y = torch.matmul(x, params[w])
    if b in params:
        y = y + params[b]
    return y


def _norm(x: torch.Tensor, params: Params, cfg: LlamaConfig) -> torch.Tensor:
    return rms_norm(x, params["scale"], cfg.rms_norm_eps, cfg.norm_unit_offset)


def layer_sliding_pattern(cfg: LlamaConfig) -> tuple[bool, ...]:
    """Per-decoder-layer local flags: the explicit pattern (Gemma's
    local/global alternation), else every layer local iff a window is set."""
    if cfg.layer_sliding is not None:
        return cfg.layer_sliding
    return (cfg.sliding_window is not None,) * cfg.num_hidden_layers


def rope_for_layer(cfg: LlamaConfig, positions: torch.Tensor, sliding=None, total_len=None):
    """cos/sin for one layer: Gemma 3's local layers take the unscaled
    ``rope_local_theta`` base, global layers ``rope_theta`` with the
    config's scaling; other families have one base. ``total_len``: the
    real sequence lengths longrope picks its table by (``ops.rope``)."""
    if cfg.rope_local_theta is not None:
        if sliding is None:
            sliding = cfg.sliding_window is not None
        if sliding:
            return rope_cos_sin(positions, cfg.head_dim, cfg.rope_local_theta)
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_spec,
                        total_len=total_len)


def _effective_window(cfg: LlamaConfig, sliding) -> int | None:
    """The layer's sliding window, or None: no window configured, or a
    global layer (``sliding`` False)."""
    return None if sliding is False else cfg.sliding_window


def _qkv_mla(attn: Params, cfg: LlamaConfig, x: torch.Tensor, positions: torch.Tensor,
             total_len=None):
    """Multi-head latent attention's q/k/v (HF DeepseekV3Attention, the JAX
    package's ``_qkv_mla``): q by LoRA (q_a -> norm -> q_b) or dense; K/V
    from a compressed latent (kv_a -> norm -> kv_b) per head into
    qk_nope keys and v_head_dim values, beside ONE rope key of qk_rope_head_dim
    shared by every head. Rope (interleaved pairs under
    ``cfg.rope_interleaved``) turns only the rope slices. Returns q/k
    [..., L, H, dn+dr] and v [..., L, H, dv], contiguous."""
    nh = cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_dim
    eps = cfg.rms_norm_eps
    lead = x.shape[:-1]
    if "q_a" in attn:
        q = torch.matmul(rms_norm(_lin(x, attn, "q_a", "bq_a"), attn["q_a_norm"], eps), attn["q_b"])
    else:
        q = torch.matmul(x, attn["wq"])  # HF's dense q_proj has no bias
    q = q.reshape(*lead, nh, dn + dr)
    ckv = _lin(x, attn, "kv_a", "bkv_a")  # [..., L, kv_lora + dr]
    c_kv, k_rot = ckv[..., : cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    kv = torch.matmul(rms_norm(c_kv, attn["kv_a_norm"], eps), attn["kv_b"]).reshape(
        *lead, nh, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = rope_cos_sin(positions, dr, cfg.rope_theta, cfg.rope_scaling_spec,
                            total_len=total_len)
    rot = apply_rope_interleaved if cfg.rope_interleaved else apply_rope
    q = torch.cat([q[..., :dn], rot(q[..., dn:], cos, sin)], dim=-1)
    k_rot = rot(k_rot[..., None, :], cos, sin)  # [..., L, 1, dr], shared by the heads
    k = torch.cat([k_nope, k_rot.expand(*k_nope.shape[:-1], dr)], dim=-1)
    return q, k, v.contiguous()


def positioned_qkv(params: Params, cfg: LlamaConfig, h: torch.Tensor, positions: torch.Tensor,
                   sliding=None, total_len=None):
    """Post-rope q [..., L, n_q, hd] and k/v [..., L, n_kv, hd] for one
    layer, with the per-head q/k RMSNorm before rope where the layer has
    one; ``positions`` broadcasts against h's leading dims ([..., L]). MLA
    (``cfg.kv_lora_rank``) assembles its own: n_kv is n_q there and v's
    head dim ``cfg.v_dim``."""
    attn = params["attn"]
    if cfg.kv_lora_rank:
        return _qkv_mla(attn, cfg, h, positions, total_len)
    hd = cfg.head_dim
    lead = h.shape[:-1]
    q = _lin(h, attn, "wq", "bq").reshape(*lead, cfg.num_attention_heads, hd)
    k = _lin(h, attn, "wk", "bk").reshape(*lead, cfg.num_key_value_heads, hd)
    v = _lin(h, attn, "wv", "bv").reshape(*lead, cfg.num_key_value_heads, hd)
    if "q_norm" in attn:
        q = rms_norm(q, attn["q_norm"], cfg.rms_norm_eps, cfg.norm_unit_offset)
        k = rms_norm(k, attn["k_norm"], cfg.rms_norm_eps, cfg.norm_unit_offset)
    cos, sin = rope_for_layer(cfg, positions, sliding, total_len)
    rot = apply_rope_interleaved if cfg.rope_interleaved else apply_rope
    return rot(q, cos, sin), rot(k, cos, sin), v


def _residual_attn(params: Params, cfg: LlamaConfig, x: torch.Tensor,
                   attn_out: torch.Tensor) -> torch.Tensor:
    """The attention sublayer's residual add; the sandwich layout norms
    the sublayer's output before the add."""
    y = _lin(attn_out.reshape(*attn_out.shape[:-2], -1), params["attn"], "wo", "bo")
    if cfg.ffw_sandwich_norms:
        y = _norm(y, params["post_attention_layernorm"], cfg)
    return x + y


def _dense_mlp(mlp: Params, x: torch.Tensor, act) -> torch.Tensor:
    return _lin(act(_lin(x, mlp, "gate", "bgate")) * _lin(x, mlp, "up", "bup"), mlp, "down", "bdown")


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties to the lower index (``lax.top_k``'s
    order; a group mask's zeros tie)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routed_experts(mlp: Params, x: torch.Tensor, top_idx: torch.Tensor, top_w: torch.Tensor,
                    act) -> torch.Tensor:
    """Sum over each token's selected experts of weight * expert(x), each
    expert computed only on the tokens that selected it: the tokens are
    grouped by expert and every group runs its expert's three matmuls. The
    weight (already in x's dtype) multiplies the activations before the
    down projection, and a weight of exactly 0 contributes exactly 0, as the
    JAX package's compute-all form with ``where(c != 0, h * c, 0)``.
    x [..., D]; top_idx/top_w [..., k]."""
    lead, d = x.shape[:-1], x.shape[-1]
    k = top_idx.shape[-1]
    x2 = x.reshape(-1, d)
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)  # (token, slot) pairs grouped by expert
    w = top_w.reshape(-1)[order, None]
    tok = order // k
    counts = torch.bincount(flat, minlength=mlp["gate"].shape[0]).tolist()
    y = x2.new_zeros(flat.numel(), d)
    start = 0
    for e, c in enumerate(counts):
        if not c:
            continue
        sel = slice(start, start + c)
        xe = x2[tok[sel]]
        h = act(torch.matmul(xe, mlp["gate"][e])) * torch.matmul(xe, mlp["up"][e])
        h = torch.where(w[sel] != 0, h * w[sel], h.new_zeros(()))
        y[order[sel]] = torch.matmul(h, mlp["down"][e])
        start += c
    return y.reshape(*lead, k, d).sum(dim=-2)


def _moe_mlp(mlp: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Mixtral / Qwen3-MoE (HF MixtralSparseMoeBlock): router logits in the
    model dtype, softmax over every expert in float32, the top k,
    renormalised iff ``moe_norm_topk_prob``, cast to x's dtype."""
    k = cfg.num_experts_per_tok
    probs = torch.softmax(torch.matmul(x, mlp["router"]).float(), dim=-1)
    top_vals, top_idx = _top_k(probs, k)
    if cfg.moe_norm_topk_prob:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return _routed_experts(mlp, x, top_idx, top_vals.to(x.dtype), _ACT[cfg.hidden_act])


def _deepseek_moe_mlp(mlp: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3 (HF DeepseekV3MoE / TopkRouter), routing in float32 end
    to end: sigmoid scores; the SELECTION adds the correction bias and is
    group-limited (n_group groups scored by their top-2 sum, the best
    topk_group kept, the others' choices filled with 0.0 as HF's
    masked_fill does); the WEIGHTS are the unbiased scores of the selected
    experts, renormalised (+1e-20) iff ``moe_norm_topk_prob``, times
    ``moe_routed_scaling_factor``; plus the shared expert."""
    e, k, g = cfg.num_local_experts, cfg.num_experts_per_tok, cfg.moe_n_group
    scores = torch.sigmoid(torch.matmul(x.float(), mlp["router"].float()))  # [..., E]
    choice = scores + mlp["correction_bias"].float()
    if g > 1:
        grouped = choice.reshape(*choice.shape[:-1], g, e // g)
        group_scores = _top_k(grouped, 2)[0].sum(dim=-1)  # [..., G]
        _, gidx = _top_k(group_scores, cfg.moe_topk_group)
        keep = torch.zeros_like(group_scores, dtype=torch.bool).scatter_(-1, gidx, True)
        choice = torch.where(keep.repeat_interleave(e // g, dim=-1), choice, 0.0)
    _, top_idx = _top_k(choice, k)
    top_w = torch.gather(scores, -1, top_idx)
    if cfg.moe_norm_topk_prob:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    top_w = top_w * cfg.moe_routed_scaling_factor
    act = _ACT[cfg.hidden_act]
    routed = _routed_experts(mlp, x, top_idx, top_w.to(x.dtype), act)
    shared = torch.matmul(act(torch.matmul(x, mlp["shared_gate"])) * torch.matmul(x, mlp["shared_up"]),
                          mlp["shared_down"])
    return routed + shared


def _mlp(mlp: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """The layer's MLP, by the keys its checkpoint has: DeepSeek's experts
    (a correction bias), the Mixtral/Qwen3-MoE experts (a router), or dense."""
    if "correction_bias" in mlp:
        return _deepseek_moe_mlp(mlp, cfg, x)
    if "router" in mlp:
        return _moe_mlp(mlp, cfg, x)
    return _dense_mlp(mlp, x, _ACT[cfg.hidden_act])


def _residual_mlp(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP sublayer's residual add: the input normed by
    post_attention_layernorm, or in the sandwich layout by
    pre_feedforward_layernorm with the output normed by
    post_feedforward_layernorm."""
    pre = "pre_feedforward_layernorm" if cfg.ffw_sandwich_norms else "post_attention_layernorm"
    y = _mlp(params["mlp"], cfg, _norm(x, params[pre], cfg))
    if cfg.ffw_sandwich_norms:
        y = _norm(y, params["post_feedforward_layernorm"], cfg)
    return x + y


def embed(params: Params, ids: torch.Tensor, dtype: torch.dtype,
          cfg: LlamaConfig | None = None) -> torch.Tensor:
    """Token ids [..., L] -> hidden states [..., L, D]. With
    ``cfg.embed_scale`` (Gemma) times sqrt(hidden_size), the factor itself
    rounded to ``dtype`` first (HF PR #29402)."""
    x = F.embedding(ids.long(), params["embedding"]).to(dtype)
    if cfg is not None and cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=dtype)
    return x


def prefix_suffix_layer(
    params: Params,
    cfg: LlamaConfig,
    prefix_h: torch.Tensor,
    suffix_h: torch.Tensor,
    prefix_len: torch.Tensor,
    return_kv: bool = False,
    sliding=None,
    total_len: torch.Tensor | None = None,
):
    """One decoder layer over a block of (prefix, suffixes) prompts.

    prefix_h [B, Lp, D] (right-padded; the first prefix_len[b] rows are
    real); suffix_h [B, S, Ls, D]; prefix_len int32 [B]. The prefix runs a
    causal self-attention once; every suffix then attends to the real
    prefix keys plus causally within itself, at rotary positions
    prefix_len + i, all within the layer's sliding window if it has one.
    ``total_len`` [B] (longrope only): each prompt's real length, which
    picks its rope table for the prefix and the suffixes alike. Returns
    (prefix_out, suffix_out) and, with ``return_kv``, the post-rope KV dict
    {'kp','vp','ks','vs'} that decode steps reuse (V at ``cfg.v_dim``).
    """
    b, lp, _ = prefix_h.shape
    ls = suffix_h.shape[2]
    dev = prefix_h.device
    window = _effective_window(cfg, sliding)
    if window is not None and lp + ls <= window:
        # At these bucket shapes every query-key distance is below the
        # window: the local mask equals the causal one, so drop it.
        window = None
    kw = dict(scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap, window=window)

    h = _norm(prefix_h, params["input_layernorm"], cfg)
    q, k, v = positioned_qkv(params, cfg, h, torch.arange(lp, device=dev)[None], sliding, total_len)
    attn = flash_causal_attention(q, k, v, prefix_len, **kw)
    prefix_out = _residual_mlp(params, cfg, _residual_attn(params, cfg, prefix_h, attn))

    hs = _norm(suffix_h, params["input_layernorm"], cfg)
    pos_s = prefix_len.to(dev).reshape(b, 1, 1) + torch.arange(ls, device=dev)  # [B, 1, Ls]
    qs, ks, vs = positioned_qkv(params, cfg, hs, pos_s, sliding, total_len)
    attn_s = flash_prefix_shared_attention(qs, k, v, ks, vs, prefix_len, **kw)
    suffix_out = _residual_mlp(params, cfg, _residual_attn(params, cfg, suffix_h, attn_s))
    if return_kv:
        return prefix_out, suffix_out, {"kp": k, "vp": v, "ks": ks, "vs": vs}
    return prefix_out, suffix_out


def decode_step_layer(
    params: Params,
    cfg: LlamaConfig,
    x: torch.Tensor,
    kv: Params,
    prefix_len: torch.Tensor,
    suffix_eos: torch.Tensor,
    t: int,
    sliding=None,
) -> torch.Tensor:
    """One decoder layer for the newest token of every suffix.

    x [B, S, 1, D]; kv {'kp','vp' [B, Lp, n_kv, hd], 'ks','vs'
    [B, S, Ls, n_kv, hd], 'kg','vg' [B, S, T, n_kv, hd]} (V at
    ``cfg.v_dim``) with generated slots < t filled; t an int. The token
    sits at rotary position prefix_len + suffix_eos + 1 + t (longrope picks
    its table by that position + 1). Its k/v are written into slot t of
    kv['kg']/kv['vg'] IN PLACE (the JAX version returns an updated copy);
    returns the layer output [B, S, 1, D]. The layer's window always
    applies (no bucket shortcut, as in the JAX package). Under MLA the
    attention is the plain decode op, the JAX package's route there (its
    decode kernel never takes MLA); every other model takes the kernel.
    """
    h = _norm(x, params["input_layernorm"], cfg)
    pos = (prefix_len.to(x.device)[:, None] + suffix_eos.to(x.device) + 1 + t)[..., None]
    total_len = pos[..., -1] + 1 if cfg.rope_scaling_kind == "longrope" else None
    q, k_new, v_new = positioned_qkv(params, cfg, h, pos, sliding, total_len)  # [B, S, 1, n, hd]
    kv["kg"][:, :, t] = k_new[:, :, 0]
    kv["vg"][:, :, t] = v_new[:, :, 0]
    attend = decode_attention if cfg.kv_lora_rank else flash_decode_attention
    attn = attend(
        q, kv["kp"], kv["vp"], kv["ks"], kv["vs"], kv["kg"], kv["vg"], prefix_len,
        suffix_eos, t, scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap,
        window=_effective_window(cfg, sliding),
    )
    return _residual_mlp(params, cfg, _residual_attn(params, cfg, x, attn))


def select_eos_and_norm(
    params: Params, cfg: LlamaConfig, suffix_h: torch.Tensor, suffix_eos: torch.Tensor
) -> torch.Tensor:
    """Keep each suffix's last real token, then RMSNorm:
    suffix_h [B, S, Ls, D], suffix_eos [B, S] -> [B, S, 1, D]."""
    idx = suffix_eos.to(suffix_h.device).long()[..., None, None].expand(
        *suffix_eos.shape, 1, suffix_h.shape[-1]
    )
    return _norm(torch.gather(suffix_h, 2, idx), params, cfg)


def lm_head_scores(params: Params, h: torch.Tensor, softcap: float | None = None) -> torch.Tensor:
    """Next-token distributions of the kept token: h [..., 1, D] -> float32
    [..., V] (final-logit softcap, then softmax)."""
    logits = torch.matmul(h, params["kernel"]).float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return torch.softmax(logits, dim=-1)[..., 0, :]


def head_params(params: Params) -> Params:
    """The lm_head kernel, honouring tied embeddings."""
    if params.get("lm_head"):
        return params["lm_head"]
    return {"kernel": params["embed"]["embedding"].T}


__all__ = [
    "decode_step_layer",
    "embed",
    "head_params",
    "layer_sliding_pattern",
    "lm_head_scores",
    "positioned_qkv",
    "prefix_suffix_layer",
    "rope_for_layer",
    "select_eos_and_norm",
]
