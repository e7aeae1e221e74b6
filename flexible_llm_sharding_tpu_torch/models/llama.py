"""Decoder layer functions for the streamed scorer, in PyTorch.

The port of the JAX package's ``models/llama.py`` on one device, for the
families the config carries (Llama, Mistral, Phi-3 once its fused
projections are split, Qwen2's q/k/v biases, Qwen3's q/k norm, the Gemma
1/2/3 deltas, the Mixtral/Qwen3-MoE, DeepSeek and Llama 4 experts,
DeepSeek's multi-head latent attention, and Llama 4's chunked and NoPE
layers), all through the same flags. Layers are plain
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
[r_kv, nq*(dn+dv)] and 'wo' [nq*dv, D]. A Llama 4 MoE layer's 'mlp' holds
'router' [D, E], the stacked experts and the shared expert, without a
correction bias.

Every function takes an explicit leading block dimension ``B`` (the JAX
package adds it with ``jax.vmap``), with per-prompt ``prefix_len [B]`` and
``suffix_eos [B, S]``. ``sliding`` is the layer's entry of
:func:`layer_sliding_pattern` (a Python bool; None for uniform configs): it
picks the layer's rope base and whether the sliding window or chunk
applies. ``rope_on`` is its entry of :func:`layer_rope_pattern` (None: rope
on): False marks a Llama 4 NoPE layer.
Attention goes through the kernel wrappers of ``ops/flash_attention.py``:
the CUDA kernels on the card, their plain versions on the CPU. Each layer
function that reaches one takes ``use_pallas``, a required keyword (the
JAX package's name;
``FrameworkConfig.use_pallas`` at the entry points): False calls the
plain versions themselves, so no kernel launches on any device. The
projections stay ``torch.matmul``, each weight cast to the activations'
dtype (:func:`_mm`). :func:`decoder_layer`, the training layer, runs the
plain ``ops/attention.attention`` under a caller's mask, as the JAX
package's does: no kernel there has a backward.

Tensor parallelism (``parallel/sharding.py``): where GSPMD partitions the
JAX layers over a ``tp`` mesh, the port's streamed layer functions and the
head take a LIST of per-rank parameter trees, rank r's Megatron slices on
its device; one device is a list of one rank, through the same code with
sums of one term. The activations stay one copy on the first rank's
device, with the embedding and the final norm (not split). Each rank runs
its own heads from the input norm's output (q/k/v, rope, the kernel or the
plain op, its slice of ``wo``) and its own slice of the MLP or its own
experts; the partial outputs are summed in rank order on the first device
(in float32 under half-precision activations across ranks, rounded once as
one device's product is), and ``bo``/``bdown``, the sandwich norms and the
residual add apply once, to the sum. The head scores each rank's
vocabulary slice and joins them before the softcap and the softmax. The KV
of a layer is a per-rank list of dicts, each rank's KV heads on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from flexible_llm_sharding_tpu_torch.config import ACTIVATIONS, LlamaConfig
from flexible_llm_sharding_tpu_torch.ops.attention import attention, decode_attention
from flexible_llm_sharding_tpu_torch.ops.flash_attention import (
    causal_attention_plain,
    flash_causal_attention,
    flash_decode_attention,
    flash_prefix_shared_attention,
    prefix_shared_attention_plain,
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


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype, the weight cast to it first (the JAX package's
    ``_mm``): float32 master weights under bf16 activations multiply in
    bf16. Where the weight already has x's dtype, as on every inference
    path, ``.to`` returns the same tensor."""
    return torch.matmul(x, w.to(x.dtype))


def _lin(x: torch.Tensor, params: Params, w: str, b: str) -> torch.Tensor:
    y = _mm(x, params[w])
    if b in params:
        y = y + params[b].to(y.dtype)
    return y


def _norm(x: torch.Tensor, params: Params, cfg: LlamaConfig) -> torch.Tensor:
    return rms_norm(x, params["scale"], cfg.rms_norm_eps, cfg.norm_unit_offset)


def _device_of(tree) -> torch.device:
    """The device of a placed tree (its first leaf's)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def _to(x, device: torch.device):
    """``x`` on ``device`` (a no-op there already), None kept."""
    return None if x is None else x.to(device)


def _acc_dtype(n_ranks: int, dtype: torch.dtype) -> torch.dtype:
    """The dtype of the ranks' partial outputs: the activations' own on one
    device; float32 across ranks, so that their sum is rounded once, as one
    device's product is."""
    return dtype if n_ranks == 1 else torch.float32


def _mm_acc(x: torch.Tensor, w: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``_mm`` with its result in ``acc``: a half-precision product
    accumulated in float32 and returned unrounded (cuBLAS's float32 output
    on a card)."""
    if acc == x.dtype:
        return _mm(x, w)
    w = w.to(x.dtype)
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=acc)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(acc), w.to(acc))


def _psum(parts: list[torch.Tensor], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The ranks' partial outputs summed in rank order on ``device`` (the
    all-reduce GSPMD inserts after a row-parallel product), then cast to
    ``dtype``; one part is itself."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    return out.to(dtype)


def layer_sliding_pattern(cfg: LlamaConfig) -> tuple[bool, ...]:
    """Per-decoder-layer local flags: the explicit pattern (Gemma's and
    Llama 4's local/global alternation), else every layer local iff a
    window or a chunk is set."""
    if cfg.layer_sliding is not None:
        return cfg.layer_sliding
    local = cfg.sliding_window is not None or cfg.attention_chunk_size is not None
    return (local,) * cfg.num_hidden_layers


def layer_rope_pattern(cfg: LlamaConfig) -> tuple[bool, ...]:
    """Per-decoder-layer rope flags (False: a Llama 4 NoPE layer); all on
    when the config sets none."""
    if cfg.layer_rope is not None:
        return cfg.layer_rope
    return (True,) * cfg.num_hidden_layers


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


def _effective_window(cfg: LlamaConfig, sliding) -> tuple[int | None, int | None]:
    """The layer's (window, chunk), each None when off: none configured, or
    a global layer (``sliding`` False)."""
    if sliding is False:
        return None, None
    return cfg.sliding_window, cfg.attention_chunk_size


def _l2_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Llama 4's weightless L2 norm (Llama4TextL2Norm): x times the float32
    reciprocal root mean square, cast back."""
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


def position_qk(cfg: LlamaConfig, q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                sliding=None, rope_on=None, total_len=None):
    """The layer's position treatment of fresh q/k heads (the JAX package's
    ``position_qk``): rope at ``positions`` (its base by ``sliding``), then
    under ``cfg.qk_l2_norm`` the weightless L2 norm. A NoPE layer
    (``rope_on`` False) keeps q/k unrotated and unnormed; under
    ``cfg.attn_temperature_tuning`` its queries are scaled in float32 by
    log(floor((pos + 1) / floor_scale) + 1) * coef + 1, computed from the
    ``positions`` tensor (on the device, so a captured graph reads the
    positions it is replayed with)."""
    if rope_on is False:
        if cfg.attn_temperature_tuning:
            pos = positions.float()
            temp = (torch.log(torch.floor((pos + 1.0) / cfg.attn_floor_scale) + 1.0)
                    * cfg.attn_scale_coef + 1.0)[..., None, None]
            q = (q.float() * temp).to(q.dtype)
        return q, k
    cos, sin = rope_for_layer(cfg, positions, sliding, total_len)
    rot = apply_rope_interleaved if cfg.rope_interleaved else apply_rope
    q, k = rot(q, cos, sin), rot(k, cos, sin)
    if cfg.qk_l2_norm:
        # HF builds Llama4TextL2Norm with config.rms_norm_eps.
        q, k = _l2_norm(q, cfg.rms_norm_eps), _l2_norm(k, cfg.rms_norm_eps)
    return q, k


def _qkv_mla(attn: Params, cfg: LlamaConfig, x: torch.Tensor, positions: torch.Tensor,
             total_len=None):
    """Multi-head latent attention's q/k/v (HF DeepseekV3Attention, the JAX
    package's ``_qkv_mla``): q by LoRA (q_a -> norm -> q_b) or dense; K/V
    from a compressed latent (kv_a -> norm -> kv_b) per head into
    qk_nope keys and v_head_dim values, beside ONE rope key of qk_rope_head_dim
    shared by every head. Rope (interleaved pairs under
    ``cfg.rope_interleaved``) turns only the rope slices. Returns q/k
    [..., L, H, dn+dr] and v [..., L, H, dv], contiguous; H is the heads
    of ``attn``'s slices (a tensor-parallel rank's own)."""
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_dim
    eps = cfg.rms_norm_eps
    lead = x.shape[:-1]
    if "q_a" in attn:
        q = _mm(rms_norm(_lin(x, attn, "q_a", "bq_a"), attn["q_a_norm"], eps), attn["q_b"])
    else:
        q = _mm(x, attn["wq"])  # HF's dense q_proj has no bias
    q = q.reshape(*lead, -1, dn + dr)
    ckv = _lin(x, attn, "kv_a", "bkv_a")  # [..., L, kv_lora + dr]
    c_kv, k_rot = ckv[..., : cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    kv = _mm(rms_norm(c_kv, attn["kv_a_norm"], eps), attn["kv_b"]).reshape(
        *lead, -1, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = rope_cos_sin(positions, dr, cfg.rope_theta, cfg.rope_scaling_spec,
                            total_len=total_len)
    rot = apply_rope_interleaved if cfg.rope_interleaved else apply_rope
    q = torch.cat([q[..., :dn], rot(q[..., dn:], cos, sin)], dim=-1)
    k_rot = rot(k_rot[..., None, :], cos, sin)  # [..., L, 1, dr], shared by the heads
    k = torch.cat([k_nope, k_rot.expand(*k_nope.shape[:-1], dr)], dim=-1)
    return q, k, v.contiguous()


def positioned_qkv(params: Params, cfg: LlamaConfig, h: torch.Tensor, positions: torch.Tensor,
                   sliding=None, total_len=None, rope_on=None):
    """Post-rope q [..., L, n_q, hd] and k/v [..., L, n_kv, hd] for one
    layer, with the per-head q/k RMSNorm before rope where the layer has
    one and :func:`position_qk` after it; ``positions`` broadcasts against
    h's leading dims ([..., L]). MLA (``cfg.kv_lora_rank``) assembles its
    own: n_kv is n_q there and v's head dim ``cfg.v_dim``. The head counts
    are those of the weights' widths, so a tensor-parallel rank's slices
    give its own heads at the config's head dim."""
    attn = params["attn"]
    if cfg.kv_lora_rank:
        return _qkv_mla(attn, cfg, h, positions, total_len)
    hd = cfg.head_dim
    lead = h.shape[:-1]
    q = _lin(h, attn, "wq", "bq").reshape(*lead, -1, hd)
    k = _lin(h, attn, "wk", "bk").reshape(*lead, -1, hd)
    v = _lin(h, attn, "wv", "bv").reshape(*lead, -1, hd)
    if "q_norm" in attn:
        q = rms_norm(q, attn["q_norm"], cfg.rms_norm_eps, cfg.norm_unit_offset)
        k = rms_norm(k, attn["k_norm"], cfg.rms_norm_eps, cfg.norm_unit_offset)
    q, k = position_qk(cfg, q, k, positions, sliding, rope_on, total_len)
    return q, k, v


def _attn_partial(attn: Params, attn_out: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """A rank's heads through its rows of ``wo`` (no bias), in ``acc``: its
    partial of the attention sublayer's output."""
    return _mm_acc(attn_out.reshape(*attn_out.shape[:-2], -1), attn["wo"], acc)


def _finish_attn(params: Params, cfg: LlamaConfig, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """The attention sublayer after the sum of its partials: ``bo``, the
    sandwich layout's norm of the output, the residual add."""
    if "bo" in params["attn"]:
        y = y + params["attn"]["bo"].to(y.dtype)
    if cfg.ffw_sandwich_norms:
        y = _norm(y, params["post_attention_layernorm"], cfg)
    return x + y


def _residual_attn(params: Params, cfg: LlamaConfig, x: torch.Tensor,
                   attn_out: torch.Tensor) -> torch.Tensor:
    """The attention sublayer's residual add on one device; the sandwich
    layout norms the sublayer's output before the add."""
    return _finish_attn(params, cfg, x, _attn_partial(params["attn"], attn_out, attn_out.dtype))


def _dense_partial(mlp: Params, x: torch.Tensor, act, acc: torch.dtype) -> torch.Tensor:
    """A rank's columns of gate/up and rows of down (no ``bdown``), in
    ``acc``."""
    return _mm_acc(act(_lin(x, mlp, "gate", "bgate")) * _lin(x, mlp, "up", "bup"), mlp["down"],
                   acc)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties to the lower index (``lax.top_k``'s
    order; a group mask's zeros tie)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routed_experts(mlp: Params, x: torch.Tensor, top_idx: torch.Tensor, top_w: torch.Tensor,
                    act, scale_input: bool = False, first: int = 0,
                    acc: torch.dtype | None = None) -> torch.Tensor:
    """Sum over each token's selected experts of weight * expert(x), each
    expert computed only on the tokens that selected it: the tokens are
    grouped by expert and every group runs its expert's three matmuls. The
    weight (already in x's dtype) multiplies the activations before the
    down projection, and a weight of exactly 0 contributes exactly 0, as the
    JAX package's compute-all form with ``where(c != 0, h * c, 0)``. With
    ``scale_input`` (Llama 4) it multiplies the expert's input instead:
    expert(weight * x), an input whose weight is 0 set to exactly 0.
    x [..., D]; top_idx/top_w [..., k] (global expert ids). ``mlp`` holds
    experts ``first`` .. ``first`` + its stack's length (an expert-parallel
    rank's); a token's slots on other experts contribute 0 here. The slots
    are summed in ``acc`` (default x's dtype)."""
    lead, d = x.shape[:-1], x.shape[-1]
    k = top_idx.shape[-1]
    x2 = x.reshape(-1, d)
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)  # (token, slot) pairs grouped by expert
    w = top_w.reshape(-1)[order, None]
    tok = order // k
    n_local = mlp["gate"].shape[0]
    counts = torch.bincount(flat, minlength=first + n_local).tolist()
    y = x2.new_zeros(flat.numel(), d)
    start = sum(counts[:first])
    for e in range(n_local):
        c = counts[first + e]
        if not c:
            continue
        sel = slice(start, start + c)
        xe = x2[tok[sel]]
        if scale_input:
            xe = torch.where(w[sel] != 0, xe * w[sel], xe.new_zeros(()))
        h = act(_mm(xe, mlp["gate"][e])) * _mm(xe, mlp["up"][e])
        if not scale_input:
            h = torch.where(w[sel] != 0, h * w[sel], h.new_zeros(()))
        y[order[sel]] = _mm(h, mlp["down"][e])
        start += c
    return y.reshape(*lead, k, d).sum(dim=-2, dtype=acc or x.dtype)


def _expert_ranks(mlps: list[Params], x: torch.Tensor, top_idx: torch.Tensor,
                  top_w: torch.Tensor, act, scale_input: bool = False, shared: bool = False):
    """A routed MoE over the ranks' ``mlp`` trees, from the routing made
    once on x's device: rank r runs its own experts (the r-th block of the
    expert axis) for every token. Returns the routed sum and, with
    ``shared``, the shared expert's (each rank's column slice of it), each
    summed over the ranks."""
    acc = _acc_dtype(len(mlps), x.dtype)
    routed, shared_parts, first = [], [], 0
    for mlp in mlps:
        d = _device_of(mlp)
        xd = x.to(d)
        routed.append(_routed_experts(mlp, xd, top_idx.to(d), top_w.to(d), act, scale_input,
                                      first, acc))
        if shared:
            shared_parts.append(_shared_expert(mlp, xd, act, acc))
        first += mlp["gate"].shape[0]
    y = _psum(routed, x.device, x.dtype)
    return y, (_psum(shared_parts, x.device, x.dtype) if shared else None)


def _moe_mlp(mlps: list[Params], cfg: LlamaConfig, x: torch.Tensor) -> list:
    """Mixtral / Qwen3-MoE (HF MixtralSparseMoeBlock): router logits in the
    model dtype, softmax over every expert in float32, the top k,
    renormalised iff ``moe_norm_topk_prob``, cast to x's dtype."""
    k = cfg.num_experts_per_tok
    probs = torch.softmax(_mm(x, mlps[0]["router"]).float(), dim=-1)
    top_vals, top_idx = _top_k(probs, k)
    if cfg.moe_norm_topk_prob:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return _expert_ranks(mlps, x, top_idx, top_vals.to(x.dtype), _ACT[cfg.hidden_act])[0]


def _shared_expert(mlp: Params, x: torch.Tensor, act, acc: torch.dtype) -> torch.Tensor:
    return _mm_acc(act(_mm(x, mlp["shared_gate"])) * _mm(x, mlp["shared_up"]), mlp["shared_down"],
                   acc)


def _llama4_moe_mlp(mlps: list[Params], cfg: LlamaConfig, x: torch.Tensor) -> list:
    """Llama 4 (HF Llama4TextMoe / Llama4Router): router logits in the
    model dtype, the top k of them in float32, their sigmoid cast to x's
    dtype scaling each selected expert's INPUT (not its output, as
    Mixtral's weights do), plus the shared expert."""
    top_vals, top_idx = _top_k(_mm(x, mlps[0]["router"]).float(), cfg.num_experts_per_tok)
    routed, shared = _expert_ranks(mlps, x, top_idx, torch.sigmoid(top_vals).to(x.dtype),
                                   _ACT[cfg.hidden_act], scale_input=True, shared=True)
    return shared + routed


def _deepseek_moe_mlp(mlps: list[Params], cfg: LlamaConfig, x: torch.Tensor) -> list:
    """DeepSeek-V3 (HF DeepseekV3MoE / TopkRouter), routing in float32 end
    to end: sigmoid scores; the SELECTION adds the correction bias and is
    group-limited (n_group groups scored by their top-2 sum, the best
    topk_group kept, the others' choices filled with 0.0 as HF's
    masked_fill does); the WEIGHTS are the unbiased scores of the selected
    experts, renormalised (+1e-20) iff ``moe_norm_topk_prob``, times
    ``moe_routed_scaling_factor``; plus the shared expert."""
    e, k, g = cfg.num_local_experts, cfg.num_experts_per_tok, cfg.moe_n_group
    mlp = mlps[0]
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
    routed, shared = _expert_ranks(mlps, x, top_idx, top_w.to(x.dtype), _ACT[cfg.hidden_act],
                                   shared=True)
    return routed + shared


def _mlp(mlps: list[Params], cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """The layer's MLP over its ranks' ``mlp`` trees, by the keys its
    checkpoint has: DeepSeek's experts (a correction bias), Llama 4's (a
    shared expert without one), the Mixtral/Qwen3-MoE experts (a router),
    or dense. The routing runs once, on x's device, from the replicated
    router; the ranks' partials are summed there, then ``bdown`` is
    added."""
    mlp = mlps[0]
    if "correction_bias" in mlp:
        return _deepseek_moe_mlp(mlps, cfg, x)
    if "shared_gate" in mlp:
        return _llama4_moe_mlp(mlps, cfg, x)
    if "router" in mlp:
        return _moe_mlp(mlps, cfg, x)
    act, acc = _ACT[cfg.hidden_act], _acc_dtype(len(mlps), x.dtype)
    y = _psum([_dense_partial(m, x.to(_device_of(m)), act, acc) for m in mlps], x.device, x.dtype)
    if "bdown" in mlp:
        y = y + mlp["bdown"].to(y.dtype)
    return y


def _residual_mlp(ranks: list[Params], cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP sublayer's residual add over a layer's rank trees: the input
    normed by post_attention_layernorm, or in the sandwich layout by
    pre_feedforward_layernorm with the output normed by
    post_feedforward_layernorm."""
    p0 = ranks[0]
    pre = "pre_feedforward_layernorm" if cfg.ffw_sandwich_norms else "post_attention_layernorm"
    y = _mlp([p["mlp"] for p in ranks], cfg, _norm(x, p0[pre], cfg))
    if cfg.ffw_sandwich_norms:
        y = _norm(y, p0["post_feedforward_layernorm"], cfg)
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


def decoder_layer(
    params: Params,
    cfg: LlamaConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    mask: torch.Tensor | None,
    sliding=None,
    rope_on=None,
    total_len=None,
) -> torch.Tensor:
    """The plain decoder layer (the JAX package's ``decoder_layer``), the
    layer training differentiates. x [..., L, D]; positions int [..., L] or
    [L]; ``mask`` broadcastable to [..., L, L], True = attend, with any
    local form already in it (the caller's, as in JAX); ``sliding`` and
    ``rope_on`` pick the layer's rope base and NoPE; ``total_len`` is
    longrope's length. Attention is the plain ``ops/attention.attention``,
    never a kernel wrapper: none of the kernels has a backward."""
    h = _norm(x, params["input_layernorm"], cfg)
    q, k, v = positioned_qkv(params, cfg, h, positions, sliding, total_len, rope_on)
    attn = attention(q, k, v, mask, scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap)
    return _residual_mlp([params], cfg, _residual_attn(params, cfg, x, attn))


def prefix_suffix_layer(
    params: list[Params],
    cfg: LlamaConfig,
    prefix_h: torch.Tensor,
    suffix_h: torch.Tensor,
    prefix_len: torch.Tensor,
    return_kv: bool = False,
    sliding=None,
    total_len: torch.Tensor | None = None,
    rope_on=None,
    *,
    use_pallas: bool,
):
    """One decoder layer over a block of (prefix, suffixes) prompts.

    prefix_h [B, Lp, D] (right-padded; the first prefix_len[b] rows are
    real); suffix_h [B, S, Ls, D]; prefix_len int32 [B]. The prefix runs a
    causal self-attention once; every suffix then attends to the real
    prefix keys plus causally within itself, at rotary positions
    prefix_len + i, all within the layer's sliding window or chunk if it
    has one.
    ``total_len`` [B] (longrope only): each prompt's real length, which
    picks its rope table for the prefix and the suffixes alike. Returns
    (prefix_out, suffix_out) and, with ``return_kv``, the post-rope KV dict
    {'kp','vp','ks','vs'} that decode steps reuse (V at ``cfg.v_dim``).
    ``use_pallas`` False runs the plain attention in place of both kernels.
    ``params`` holds the layer's rank trees (one on one device): each rank
    runs both kernels on its own heads, and the KV is a per-rank list of
    dicts.
    """
    ranks = params
    lp = prefix_h.shape[1]
    dev = prefix_h.device
    kw = _scoring_kw(cfg, sliding, lp, suffix_h.shape[2])

    h = _norm(prefix_h, ranks[0]["input_layernorm"], cfg)
    pos = torch.arange(lp, device=dev)[None]
    causal = flash_causal_attention if use_pallas else causal_attention_plain
    acc = _acc_dtype(len(ranks), prefix_h.dtype)
    parts, kps, vps = [], [], []
    for p in ranks:
        d = _device_of(p)
        q, k, v = positioned_qkv(p, cfg, h.to(d), pos.to(d), sliding, _to(total_len, d), rope_on)
        parts.append(_attn_partial(p["attn"], causal(q, k, v, prefix_len.to(d), **kw), acc))
        kps.append(k)
        vps.append(v)
    prefix_out = _residual_mlp(params, cfg, _finish_attn(ranks[0], cfg, prefix_h,
                                                         _psum(parts, dev, prefix_h.dtype)))

    suffix_out, kss, vss = _suffix_half(ranks, cfg, kps, vps, suffix_h, prefix_len, sliding,
                                        total_len, rope_on, kw, use_pallas)
    if return_kv:
        kv = [{"kp": k, "vp": v, "ks": ks, "vs": vs} for k, v, ks, vs in zip(kps, vps, kss, vss)]
        return prefix_out, suffix_out, kv
    return prefix_out, suffix_out


def _scoring_kw(cfg: LlamaConfig, sliding, lp: int, ls: int) -> dict:
    """The scoring kernels' keywords for a layer at bucket shapes (lp, ls)."""
    window, chunk = _effective_window(cfg, sliding)
    if (window is not None and lp + ls <= window) or (chunk is not None and lp + ls <= chunk):
        # At these bucket shapes every query-key distance is below the
        # window (every position in chunk 0): the local mask equals the
        # causal one, so drop it.
        window = chunk = None
    return dict(scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap, window=window, chunk=chunk)


def _suffix_half(ranks: list, cfg, kps: list, vps: list, suffix_h, prefix_len, sliding, total_len,
                 rope_on, kw, use_pallas: bool):
    """The suffix stream of a layer over each rank's post-rope prefix KV
    (kps[r], vps[r]): (suffix_out, each rank's ks, each rank's vs)."""
    b, _, ls, _ = suffix_h.shape
    dev = suffix_h.device
    hs = _norm(suffix_h, ranks[0]["input_layernorm"], cfg)
    pos_s = prefix_len.to(dev).reshape(b, 1, 1) + torch.arange(ls, device=dev)  # [B, 1, Ls]
    shared = flash_prefix_shared_attention if use_pallas else prefix_shared_attention_plain
    acc = _acc_dtype(len(ranks), suffix_h.dtype)
    parts, kss, vss = [], [], []
    for p, kp, vp in zip(ranks, kps, vps):
        d = _device_of(p)
        qs, ks, vs = positioned_qkv(p, cfg, hs.to(d), pos_s.to(d), sliding, _to(total_len, d),
                                    rope_on)
        parts.append(_attn_partial(p["attn"], shared(qs, kp, vp, ks, vs, prefix_len.to(d), **kw),
                                   acc))
        kss.append(ks)
        vss.append(vs)
    suffix_out = _residual_mlp(ranks, cfg, _finish_attn(ranks[0], cfg, suffix_h,
                                                        _psum(parts, dev, suffix_h.dtype)))
    return suffix_out, kss, vss


def suffix_only_layer(
    params: list[Params],
    cfg: LlamaConfig,
    kp: list[torch.Tensor],
    vp: list[torch.Tensor],
    suffix_h: torch.Tensor,
    prefix_len: torch.Tensor,
    sliding=None,
    total_len: torch.Tensor | None = None,
    rope_on=None,
    *,
    use_pallas: bool,
):
    """The suffix half of :func:`prefix_suffix_layer`, fed a cached prefix
    KV (the paged prefix-KV pool's reuse path, ``runtime/kvpool.py``).

    The suffix stream depends on the prefix only through its post-rope
    (k, v), so with each rank's kp/vp [B, Lp, n_kv, hd / v_dim] (lists,
    like ``params``) at the Lp bucket the
    prefix was prefilled at (rows past prefix_len are the masked pad tail)
    this runs the same norm, rotary positions prefix_len + i, prefix-shared
    kernel and residual MLP as the full layer: bit-equal to its suffix
    stream. Returns (suffix_out, each rank's {'ks', 'vs'}); the caller
    re-attaches kp/vp for the decode KV.
    """
    kw = _scoring_kw(cfg, sliding, kp[0].shape[1], suffix_h.shape[2])
    suffix_out, kss, vss = _suffix_half(params, cfg, kp, vp, suffix_h, prefix_len, sliding,
                                        total_len, rope_on, kw, use_pallas)
    return suffix_out, [{"ks": ks, "vs": vs} for ks, vs in zip(kss, vss)]


def decode_step_layer(
    params: list[Params],
    cfg: LlamaConfig,
    x: torch.Tensor,
    kv: list[Params],
    prefix_len: torch.Tensor,
    suffix_eos: torch.Tensor,
    t,
    sliding=None,
    rope_on=None,
    *,
    use_pallas: bool,
) -> torch.Tensor:
    """One decoder layer for the K newest tokens of every suffix.

    x [B, S, K, D] (K 1 for plain decode, draft + 1 for a speculative
    verify pass); kv {'kp','vp' [B, Lp, n_kv, hd], 'ks','vs'
    [B, S, Ls, n_kv, hd], 'kg','vg' [B, S, T, n_kv, hd]} (V at
    ``cfg.v_dim``) with generated slots < t filled; t an int, or an int
    [B, S] tensor of per-suffix slot offsets (speculative passes: suffixes
    accept different draft counts, so their slot clocks drift apart). Fed
    token j of suffix s sits at rotary position prefix_len + suffix_eos[s]
    + 1 + t(+j) (longrope picks its table by the last one + 1), and its k/v
    are written into slot t(+j) of kv['kg']/kv['vg'] IN PLACE (the JAX
    version returns an updated copy; the write start is clamped so the K
    slots fit, as ``dynamic_update_slice`` clamps). Returns the layer output
    [B, S, K, D]. The attention takes the JAX package's route
    (``models/llama.py:886``): the decode kernel for one token at a shared
    int t outside MLA under ``use_pallas``, else the plain
    ``decode_attention`` op. The layer's
    window or chunk always applies (no bucket shortcut, as in the JAX
    package). ``params`` and ``kv`` hold the layer's ranks (one on one
    device): each rank writes and attends its own KV heads on its device.
    """
    ranks, kvs = params, kv
    b, s, kq = x.shape[:3]
    dev = x.device
    tg = kvs[0]["kg"].shape[2]
    scalar_t = isinstance(t, int)
    base = t if scalar_t else t.to(dev)
    h = _norm(x, ranks[0]["input_layernorm"], cfg)
    pos = (prefix_len.to(dev)[:, None] + suffix_eos.to(dev) + 1 + base)[..., None] \
        + torch.arange(kq, device=dev)  # [B, S, K]
    total_len = pos[..., -1] + 1 if cfg.rope_scaling_kind == "longrope" else None
    if not scalar_t:
        slots = base.long().clamp(0, tg - kq)[..., None] + torch.arange(kq, device=dev)
        rows = torch.arange(b, device=dev)[:, None, None]
        cols = torch.arange(s, device=dev)[None, :, None]
    attend = (flash_decode_attention
              if use_pallas and kq == 1 and scalar_t and not cfg.kv_lora_rank
              else decode_attention)
    window, chunk = _effective_window(cfg, sliding)
    acc = _acc_dtype(len(ranks), x.dtype)
    parts = []
    for p, kvr in zip(ranks, kvs):
        d = _device_of(p)
        q, k_new, v_new = positioned_qkv(p, cfg, h.to(d), pos.to(d), sliding, _to(total_len, d),
                                         rope_on)  # [B, S, K, n, hd]
        if scalar_t:
            start = min(max(t, 0), tg - kq)
            kvr["kg"][:, :, start:start + kq] = k_new
            kvr["vg"][:, :, start:start + kq] = v_new
        else:
            at = (rows.to(d), cols.to(d), slots.to(d))
            kvr["kg"][at] = k_new
            kvr["vg"][at] = v_new
        attn = attend(
            q, kvr["kp"], kvr["vp"], kvr["ks"], kvr["vs"], kvr["kg"], kvr["vg"], prefix_len.to(d),
            suffix_eos.to(d), t if scalar_t else t.to(d), scale=cfg.attn_scale,
            softcap=cfg.attn_logit_softcap, window=window, chunk=chunk,
        )
        parts.append(_attn_partial(p["attn"], attn, acc))
    return _residual_mlp(ranks, cfg, _finish_attn(ranks[0], cfg, x, _psum(parts, dev, x.dtype)))


def select_eos_and_norm(
    params: Params, cfg: LlamaConfig, suffix_h: torch.Tensor, suffix_eos: torch.Tensor
) -> torch.Tensor:
    """Keep each suffix's last real token, then RMSNorm:
    suffix_h [B, S, Ls, D], suffix_eos [B, S] -> [B, S, 1, D]."""
    idx = suffix_eos.to(suffix_h.device).long()[..., None, None].expand(
        *suffix_eos.shape, 1, suffix_h.shape[-1]
    )
    return _norm(torch.gather(suffix_h, 2, idx), params, cfg)


def lm_head_scores_multi(params: list[Params], h: torch.Tensor,
                         softcap: float | None = None) -> torch.Tensor:
    """Next-token distributions at every position: h [..., K, D] -> float32
    [..., K, V] (final-logit softcap, then softmax). The speculative verify
    pass scores each fed position. ``params`` holds the head's rank trees
    (one on one device): each rank scores its vocabulary slice, and the
    slices are joined on h's device before the softcap and the softmax."""
    parts = [torch.matmul(h.to(_device_of(p)), p["kernel"]).float() for p in params]
    logits = parts[0] if len(parts) == 1 else torch.cat([x.to(h.device) for x in parts], dim=-1)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return torch.softmax(logits, dim=-1)


def lm_head_scores(params: list[Params], h: torch.Tensor,
                   softcap: float | None = None) -> torch.Tensor:
    """Next-token distributions of the kept token: h [..., 1, D] -> float32
    [..., V]; ``params`` as :func:`lm_head_scores_multi`'s."""
    return lm_head_scores_multi(params, h, softcap)[..., 0, :]


def head_params(params: Params) -> Params:
    """The lm_head kernel, honouring tied embeddings."""
    if params.get("lm_head"):
        return params["lm_head"]
    return {"kernel": params["embed"]["embedding"].T}


def forward_full(params: Params, cfg: LlamaConfig, ids: torch.Tensor,
                 dtype: torch.dtype = torch.float32, total_len=None, *,
                 use_pallas: bool) -> torch.Tensor:
    """The monolithic causal forward (the JAX package's ``forward_full``):
    ids [B, L] -> float32 logits [B, L, V]. ``params``: {'embed', 'layers'
    (a list in model order), 'norm', optional 'lm_head'}; each layer takes
    its own local window or chunk and rope flag, and the final-logit softcap
    applies. ``total_len`` (longrope) defaults to L, as a Hugging Face batch
    forward picks its table by the padded length.

    The attention is :func:`flash_causal_attention` at a valid length of L:
    the causal kernel on a card, its plain version on the CPU (and on the
    card too when ``use_pallas`` is False). Right padding
    is causally invisible to every row before it, so a caller that reads
    row n - 1 of a right-padded batch reads the unpadded forward's."""
    b, length = ids.shape
    dev = ids.device
    if total_len is None and cfg.rope_scaling_kind == "longrope":
        total_len = length
    x = embed(params["embed"], ids, dtype, cfg)
    positions = torch.arange(length, device=dev)[None]
    valid = torch.full((b,), length, dtype=torch.int32, device=dev)
    sliding, rope_on = layer_sliding_pattern(cfg), layer_rope_pattern(cfg)
    causal = flash_causal_attention if use_pallas else causal_attention_plain
    for i, layer in enumerate(params["layers"]):
        h = _norm(x, layer["input_layernorm"], cfg)
        q, k, v = positioned_qkv(layer, cfg, h, positions, sliding[i], total_len, rope_on[i])
        attn = causal(q, k, v, valid, **_scoring_kw(cfg, sliding[i], length, 0))
        x = _residual_mlp([layer], cfg, _residual_attn(layer, cfg, x, attn))
    x = rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps, cfg.norm_unit_offset)
    logits = torch.matmul(x, head_params(params)["kernel"]).float()
    if cfg.final_logit_softcap is not None:
        logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits


# ---------------------------------------------------------------------------
# Initialisation (tests, training from scratch, chip_smoke's seeded models)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape: tuple, scale: float, dtype: torch.dtype,
            device) -> torch.Tensor:
    """Normal draws times ``scale`` in float32, then cast (the JAX package's
    ``(normal * scale).astype(dtype)``)."""
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _glorot(gen, shape: tuple, dtype, device) -> torch.Tensor:
    """A linear kernel [..., fan_in, fan_out] at scale sqrt(2 / (fan_in +
    fan_out))."""
    return _normal(gen, shape, (2.0 / (shape[-2] + shape[-1])) ** 0.5, dtype, device)


def init_layer_params(gen: torch.Generator, cfg: LlamaConfig, dtype: torch.dtype = torch.float32,
                      device=None) -> Params:
    """One decoder layer's random parameters: the JAX package's
    ``init_layer_params`` tree, key order, shapes, dtypes and per-leaf
    scales, drawn from ``gen`` on ``device`` (default: the generator's).
    The draws are not JAX's."""
    device = gen.device if device is None else device
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def lin(fan_in, fan_out):
        return _glorot(gen, (fan_in, fan_out), dtype, device)

    def bias(n):
        return _normal(gen, (n,), 0.02, dtype, device)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    if cfg.kv_lora_rank:
        attn = {
            "kv_a": lin(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            "kv_a_norm": ones(cfg.kv_lora_rank),
            "kv_b": lin(cfg.kv_lora_rank, nq * (cfg.qk_nope_head_dim + cfg.v_dim)),
            "wo": lin(nq * cfg.v_dim, d),
        }
        if cfg.q_lora_rank:
            attn |= {"q_a": lin(d, cfg.q_lora_rank), "q_a_norm": ones(cfg.q_lora_rank),
                     "q_b": lin(cfg.q_lora_rank, nq * hd)}
        else:
            attn["wq"] = lin(d, nq * hd)
        if cfg.attention_in_bias:
            # HF deepseek's attention_bias: q_a_proj and kv_a_proj_with_mqa.
            attn["bkv_a"] = bias(cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            if cfg.q_lora_rank:
                attn["bq_a"] = bias(cfg.q_lora_rank)
    else:
        attn = {"wq": lin(d, nq * hd), "wk": lin(d, nkv * hd), "wv": lin(d, nkv * hd),
                "wo": lin(nq * hd, d)}
    if cfg.attention_in_bias and not cfg.kv_lora_rank:
        attn |= {"bq": bias(nq * hd), "bk": bias(nkv * hd), "bv": bias(nkv * hd)}
    if cfg.attention_out_bias:
        attn["bo"] = bias(d)
    if cfg.qk_norm:
        attn |= {"q_norm": ones(hd), "k_norm": ones(hd)}
    if cfg.num_local_experts:
        e = cfg.num_local_experts
        mlp = {"router": lin(d, e), "gate": _glorot(gen, (e, d, f), dtype, device),
               "up": _glorot(gen, (e, d, f), dtype, device),
               "down": _glorot(gen, (e, f, d), dtype, device)}
    else:
        mlp = {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)}
        if cfg.mlp_bias:
            mlp |= {"bgate": bias(f), "bup": bias(f), "bdown": bias(d)}
    out = {
        "input_layernorm": {"scale": ones(d)},
        "post_attention_layernorm": {"scale": ones(d)},
        "attn": attn,
        "mlp": mlp,
    }
    if cfg.ffw_sandwich_norms:
        out["pre_feedforward_layernorm"] = {"scale": ones(d)}
        out["post_feedforward_layernorm"] = {"scale": ones(d)}
    return out


def init_mixed_params(gen: torch.Generator, cfg: LlamaConfig, dtype: torch.dtype = torch.float32,
                      device=None) -> Params:
    """Random parameters of a mixed dense/MoE stack (``cfg.moe_layer_pattern``),
    the JAX package's ``init_mixed_params`` tree: dense layers at the
    family's dense width (Llama 4's ``intermediate_size_mlp``), MoE layers
    with stacked experts, plus Llama 4's and DeepSeek's shared expert (and
    DeepSeek's float32 correction bias, scale 0.1)."""
    if cfg.moe_layer_pattern is None:
        raise ValueError("init_mixed_params needs cfg.moe_layer_pattern")
    device = gen.device if device is None else device
    dense_cfg = dataclasses.replace(
        cfg, model_type="llama", num_local_experts=0,
        intermediate_size=cfg.intermediate_size_mlp or cfg.intermediate_size,
        moe_layer_pattern=None, intermediate_size_mlp=None)
    moe_cfg = dataclasses.replace(cfg, moe_layer_pattern=None)
    layers = []
    for is_moe in cfg.moe_layer_pattern:
        lp = init_layer_params(gen, moe_cfg if is_moe else dense_cfg, dtype, device)
        if is_moe and cfg.model_type in ("llama4_text", "deepseek_v3"):
            d, f = cfg.hidden_size, cfg.intermediate_size
            if cfg.model_type == "deepseek_v3":
                f *= cfg.n_shared_experts  # one MLP of n_shared_experts x the routed width
            lp["mlp"] |= {"shared_gate": _glorot(gen, (d, f), dtype, device),
                          "shared_up": _glorot(gen, (d, f), dtype, device),
                          "shared_down": _glorot(gen, (f, d), dtype, device)}
            if cfg.model_type == "deepseek_v3":
                lp["mlp"]["correction_bias"] = _normal(
                    gen, (cfg.num_local_experts,), 0.1, torch.float32, device)
        layers.append(lp)
    # embed, norm and lm_head only: a 0-layer view (its per-layer lists go).
    head_cfg = dataclasses.replace(dense_cfg, num_hidden_layers=0, layer_sliding=None,
                                   layer_rope=None)
    params = init_params(gen, head_cfg, dtype, device)
    params["layers"] = layers
    return params


def init_params(gen: torch.Generator, cfg: LlamaConfig, dtype: torch.dtype = torch.float32,
                device=None) -> Params:
    """Random parameters of the whole model, the JAX package's
    ``init_params`` tree ({'embed', 'layers' (a list), 'norm', and 'lm_head'
    unless the embeddings are tied}), drawn from ``gen`` on ``device``."""
    device = gen.device if device is None else device
    v, d = cfg.vocab_size, cfg.hidden_size
    params: Params = {
        "embed": {"embedding": _normal(gen, (v, d), 0.02, dtype, device)},
        "layers": [init_layer_params(gen, cfg, dtype, device)
                   for _ in range(cfg.num_hidden_layers)],
        "norm": {"scale": torch.ones(d, dtype=dtype, device=device)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": _normal(gen, (d, v), 0.02, dtype, device)}
    return params


__all__ = [
    "decode_step_layer",
    "decoder_layer",
    "embed",
    "forward_full",
    "head_params",
    "init_layer_params",
    "init_mixed_params",
    "init_params",
    "layer_rope_pattern",
    "layer_sliding_pattern",
    "lm_head_scores",
    "lm_head_scores_multi",
    "position_qk",
    "positioned_qkv",
    "prefix_suffix_layer",
    "rope_for_layer",
    "select_eos_and_norm",
    "suffix_only_layer",
]
