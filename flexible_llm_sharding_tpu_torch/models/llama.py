"""Dense Llama layer functions for the streamed scorer, in PyTorch.

The port of the JAX package's ``models/llama.py`` for dense Llama on one
device. Layers are plain functions over parameter dictionaries, so streaming
a layer is passing another dictionary. The layout and key names are the JAX
package's (linear kernels stored [in, out]), so a checkpoint reads the same
in both packages:

    layer = {
      'input_layernorm': {'scale': [D]},
      'post_attention_layernorm': {'scale': [D]},
      'attn': {'wq': [D, nq*hd], 'wk': [D, nkv*hd], 'wv': [D, nkv*hd],
               'wo': [nq*hd, D], optional 'bq', 'bk', 'bv', 'bo'},
      'mlp':  {'gate': [D, F], 'up': [D, F], 'down': [F, D],
               optional 'bgate', 'bup', 'bdown'},
    }

Every function takes an explicit leading block dimension ``B`` (the JAX
package adds it with ``jax.vmap``), with per-prompt ``prefix_len [B]`` and
``suffix_eos [B, S]``. Attention goes through the kernel wrappers of
``ops/flash_attention.py``: the CUDA kernels on the card, their plain
versions on the CPU. The projections stay ``torch.matmul``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.ops.flash_attention import (
    flash_causal_attention,
    flash_decode_attention,
    flash_prefix_shared_attention,
)
from flexible_llm_sharding_tpu_torch.ops.norm import rms_norm
from flexible_llm_sharding_tpu_torch.ops.rope import apply_rope, rope_cos_sin

Params = dict[str, Any]


def _lin(x: torch.Tensor, params: Params, w: str, b: str) -> torch.Tensor:
    y = torch.matmul(x, params[w])
    if b in params:
        y = y + params[b]
    return y


def positioned_qkv(params: Params, cfg: LlamaConfig, h: torch.Tensor, positions: torch.Tensor):
    """Post-rope q [..., L, n_q, hd] and k/v [..., L, n_kv, hd] for one
    layer; ``positions`` broadcasts against h's leading dims ([..., L])."""
    attn = params["attn"]
    hd = cfg.head_dim
    lead = h.shape[:-1]
    q = _lin(h, attn, "wq", "bq").reshape(*lead, cfg.num_attention_heads, hd)
    k = _lin(h, attn, "wk", "bk").reshape(*lead, cfg.num_key_value_heads, hd)
    v = _lin(h, attn, "wv", "bv").reshape(*lead, cfg.num_key_value_heads, hd)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _residual_attn(params: Params, x: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
    o = attn_out.reshape(*attn_out.shape[:-2], -1)
    return x + _lin(o, params["attn"], "wo", "bo")


def _residual_mlp(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, params["post_attention_layernorm"]["scale"], cfg.rms_norm_eps)
    mlp = params["mlp"]
    y = F.silu(_lin(h, mlp, "gate", "bgate")) * _lin(h, mlp, "up", "bup")
    return x + _lin(y, mlp, "down", "bdown")


def embed(params: Params, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token ids [..., L] -> hidden states [..., L, D]."""
    return F.embedding(ids.long(), params["embedding"]).to(dtype)


def prefix_suffix_layer(
    params: Params,
    cfg: LlamaConfig,
    prefix_h: torch.Tensor,
    suffix_h: torch.Tensor,
    prefix_len: torch.Tensor,
    return_kv: bool = False,
):
    """One decoder layer over a block of (prefix, suffixes) prompts.

    prefix_h [B, Lp, D] (right-padded; the first prefix_len[b] rows are
    real); suffix_h [B, S, Ls, D]; prefix_len int32 [B]. The prefix runs a
    causal self-attention once; every suffix then attends to the real
    prefix keys plus causally within itself, at rotary positions
    prefix_len + i. Returns (prefix_out, suffix_out) and, with
    ``return_kv``, the post-rope KV dict {'kp','vp','ks','vs'} that decode
    steps reuse.
    """
    b, lp, _ = prefix_h.shape
    ls = suffix_h.shape[2]
    dev = prefix_h.device
    eps = cfg.rms_norm_eps
    kw = dict(scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap)

    h = rms_norm(prefix_h, params["input_layernorm"]["scale"], eps)
    q, k, v = positioned_qkv(params, cfg, h, torch.arange(lp, device=dev))
    attn = flash_causal_attention(q, k, v, prefix_len, **kw)
    prefix_out = _residual_mlp(params, cfg, _residual_attn(params, prefix_h, attn))

    hs = rms_norm(suffix_h, params["input_layernorm"]["scale"], eps)
    pos_s = prefix_len.to(dev).reshape(b, 1, 1) + torch.arange(ls, device=dev)  # [B, 1, Ls]
    qs, ks, vs = positioned_qkv(params, cfg, hs, pos_s)
    attn_s = flash_prefix_shared_attention(qs, k, v, ks, vs, prefix_len, **kw)
    suffix_out = _residual_mlp(params, cfg, _residual_attn(params, suffix_h, attn_s))
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
) -> torch.Tensor:
    """One decoder layer for the newest token of every suffix.

    x [B, S, 1, D]; kv {'kp','vp' [B, Lp, n_kv, hd], 'ks','vs'
    [B, S, Ls, n_kv, hd], 'kg','vg' [B, S, T, n_kv, hd]} with generated
    slots < t filled; t an int. The token sits at rotary position
    prefix_len + suffix_eos + 1 + t. Its k/v are written into slot t of
    kv['kg']/kv['vg'] IN PLACE (the JAX version returns an updated copy);
    returns the layer output [B, S, 1, D].
    """
    h = rms_norm(x, params["input_layernorm"]["scale"], cfg.rms_norm_eps)
    pos = (prefix_len.to(x.device)[:, None] + suffix_eos.to(x.device) + 1 + t)[..., None]
    q, k_new, v_new = positioned_qkv(params, cfg, h, pos)  # [B, S, 1, n, hd]
    kv["kg"][:, :, t] = k_new[:, :, 0]
    kv["vg"][:, :, t] = v_new[:, :, 0]
    attn = flash_decode_attention(
        q, kv["kp"], kv["vp"], kv["ks"], kv["vs"], kv["kg"], kv["vg"], prefix_len,
        suffix_eos, t, scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap,
    )
    return _residual_mlp(params, cfg, _residual_attn(params, x, attn))


def select_eos_and_norm(
    params: Params, cfg: LlamaConfig, suffix_h: torch.Tensor, suffix_eos: torch.Tensor
) -> torch.Tensor:
    """Keep each suffix's last real token, then RMSNorm:
    suffix_h [B, S, Ls, D], suffix_eos [B, S] -> [B, S, 1, D]."""
    idx = suffix_eos.to(suffix_h.device).long()[..., None, None].expand(
        *suffix_eos.shape, 1, suffix_h.shape[-1]
    )
    last = torch.gather(suffix_h, 2, idx)
    return rms_norm(last, params["scale"], cfg.rms_norm_eps)


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
    "lm_head_scores",
    "positioned_qkv",
    "prefix_suffix_layer",
    "select_eos_and_norm",
]
