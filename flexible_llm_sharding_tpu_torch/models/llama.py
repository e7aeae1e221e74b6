"""Decoder layer functions for the streamed scorer, in PyTorch.

The port of the JAX package's ``models/llama.py`` on one device, for the
dense families the config carries (Llama, Mistral, Phi-3 once its fused
projections are split, Qwen2's q/k/v biases, Qwen3's q/k norm, and the
Gemma 1/2/3 deltas), all through the same flags. Layers are plain functions over
parameter dictionaries, so streaming a layer is passing another dictionary.
The layout and key names are the JAX package's (linear kernels stored
[in, out]), so a checkpoint reads the same in both packages:

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
from flexible_llm_sharding_tpu_torch.ops.flash_attention import (
    flash_causal_attention,
    flash_decode_attention,
    flash_prefix_shared_attention,
)
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.ops.rope import apply_rope, rope_cos_sin

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


def rope_for_layer(cfg: LlamaConfig, positions: torch.Tensor, sliding=None):
    """cos/sin for one layer: Gemma 3's local layers take the unscaled
    ``rope_local_theta`` base, global layers ``rope_theta`` with the
    config's scaling; other families have one base."""
    if cfg.rope_local_theta is not None:
        if sliding is None:
            sliding = cfg.sliding_window is not None
        if sliding:
            return rope_cos_sin(positions, cfg.head_dim, cfg.rope_local_theta)
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_spec)


def _effective_window(cfg: LlamaConfig, sliding) -> int | None:
    """The layer's sliding window, or None: no window configured, or a
    global layer (``sliding`` False)."""
    return None if sliding is False else cfg.sliding_window


def positioned_qkv(params: Params, cfg: LlamaConfig, h: torch.Tensor, positions: torch.Tensor,
                   sliding=None):
    """Post-rope q [..., L, n_q, hd] and k/v [..., L, n_kv, hd] for one
    layer, with the per-head q/k RMSNorm before rope where the layer has
    one; ``positions`` broadcasts against h's leading dims ([..., L])."""
    attn = params["attn"]
    hd = cfg.head_dim
    lead = h.shape[:-1]
    q = _lin(h, attn, "wq", "bq").reshape(*lead, cfg.num_attention_heads, hd)
    k = _lin(h, attn, "wk", "bk").reshape(*lead, cfg.num_key_value_heads, hd)
    v = _lin(h, attn, "wv", "bv").reshape(*lead, cfg.num_key_value_heads, hd)
    if "q_norm" in attn:
        q = rms_norm(q, attn["q_norm"], cfg.rms_norm_eps, cfg.norm_unit_offset)
        k = rms_norm(k, attn["k_norm"], cfg.rms_norm_eps, cfg.norm_unit_offset)
    cos, sin = rope_for_layer(cfg, positions, sliding)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _residual_attn(params: Params, cfg: LlamaConfig, x: torch.Tensor,
                   attn_out: torch.Tensor) -> torch.Tensor:
    """The attention sublayer's residual add; the sandwich layout norms
    the sublayer's output before the add."""
    y = _lin(attn_out.reshape(*attn_out.shape[:-2], -1), params["attn"], "wo", "bo")
    if cfg.ffw_sandwich_norms:
        y = _norm(y, params["post_attention_layernorm"], cfg)
    return x + y


def _residual_mlp(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP sublayer's residual add: the input normed by
    post_attention_layernorm, or in the sandwich layout by
    pre_feedforward_layernorm with the output normed by
    post_feedforward_layernorm."""
    pre = "pre_feedforward_layernorm" if cfg.ffw_sandwich_norms else "post_attention_layernorm"
    h = _norm(x, params[pre], cfg)
    mlp = params["mlp"]
    y = _ACT[cfg.hidden_act](_lin(h, mlp, "gate", "bgate")) * _lin(h, mlp, "up", "bup")
    y = _lin(y, mlp, "down", "bdown")
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
):
    """One decoder layer over a block of (prefix, suffixes) prompts.

    prefix_h [B, Lp, D] (right-padded; the first prefix_len[b] rows are
    real); suffix_h [B, S, Ls, D]; prefix_len int32 [B]. The prefix runs a
    causal self-attention once; every suffix then attends to the real
    prefix keys plus causally within itself, at rotary positions
    prefix_len + i, all within the layer's sliding window if it has one.
    Returns (prefix_out, suffix_out) and, with ``return_kv``, the post-rope
    KV dict {'kp','vp','ks','vs'} that decode steps reuse.
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
    q, k, v = positioned_qkv(params, cfg, h, torch.arange(lp, device=dev), sliding)
    attn = flash_causal_attention(q, k, v, prefix_len, **kw)
    prefix_out = _residual_mlp(params, cfg, _residual_attn(params, cfg, prefix_h, attn))

    hs = _norm(suffix_h, params["input_layernorm"], cfg)
    pos_s = prefix_len.to(dev).reshape(b, 1, 1) + torch.arange(ls, device=dev)  # [B, 1, Ls]
    qs, ks, vs = positioned_qkv(params, cfg, hs, pos_s, sliding)
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
    [B, S, Ls, n_kv, hd], 'kg','vg' [B, S, T, n_kv, hd]} with generated
    slots < t filled; t an int. The token sits at rotary position
    prefix_len + suffix_eos + 1 + t. Its k/v are written into slot t of
    kv['kg']/kv['vg'] IN PLACE (the JAX version returns an updated copy);
    returns the layer output [B, S, 1, D]. The layer's window always
    applies (no bucket shortcut, as in the JAX package).
    """
    h = _norm(x, params["input_layernorm"], cfg)
    pos = (prefix_len.to(x.device)[:, None] + suffix_eos.to(x.device) + 1 + t)[..., None]
    q, k_new, v_new = positioned_qkv(params, cfg, h, pos, sliding)  # [B, S, 1, n, hd]
    kv["kg"][:, :, t] = k_new[:, :, 0]
    kv["vg"][:, :, t] = v_new[:, :, 0]
    attn = flash_decode_attention(
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
