"""Rotary position embeddings with HF Llama semantics (the JAX package's
``ops/rope.py``): the angle table in float32 from frequencies computed in
float64 on the host, the rotation in the activation dtype. Unscaled, or
with one of the scalings of ``LlamaConfig.rope_scaling_spec``: linear (every
frequency divided by the factor), llama3 (frequency bands), yarn
(NTK-by-parts, with an attention factor on cos/sin) and longrope (per-band
extension factors, long or short by the sequence's real length)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, scaling: tuple | None = None) -> np.ndarray:
    freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling is None:
        return freq.astype(np.float32)
    kind = scaling[0]
    if kind == "linear":
        freq = freq / scaling[1]
    elif kind == "llama3":
        # transformers _compute_llama3_parameters: low-frequency bands divided
        # by the factor, high-frequency bands kept, the middle interpolated.
        (_, factor, low_ff, high_ff, orig_max) = scaling
        wavelen = 2.0 * np.pi / freq
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        interp = (1.0 - smooth) * freq / factor + smooth * freq
        freq = np.where(wavelen < orig_max / high_ff, freq,
                        np.where(wavelen > orig_max / low_ff, freq / factor, interp))
    elif kind == "yarn":
        # transformers _compute_yarn_parameters: high-frequency dims keep their
        # frequency, low-frequency dims are divided by the factor, with a
        # linear ramp between the correction dims of beta_fast and beta_slow
        # rotations at the original context length. The attention factor is
        # applied to cos/sin in rope_cos_sin.
        (_, factor, beta_fast, beta_slow, orig_max, _af, truncate) = scaling

        def correction_dim(num_rot):
            return head_dim * np.log(orig_max / (num_rot * 2.0 * np.pi)) / (2.0 * np.log(theta))

        low, high = correction_dim(beta_fast), correction_dim(beta_slow)
        if truncate:
            low, high = np.floor(low), np.ceil(high)
        low, high = max(low, 0.0), min(high, head_dim - 1.0)
        if low == high:
            high += 0.001  # HF linear_ramp_factor's guard
        ramp = np.clip((np.arange(head_dim // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
        extrap = 1.0 - ramp
        freq = (freq / factor) * (1.0 - extrap) + freq * extrap
    elif kind == "longrope_ext":
        # One table of transformers _compute_longrope_parameters: the base
        # frequencies divided by the per-band extension factors. rope_cos_sin
        # picks the long or the short table by the real sequence length.
        ext = np.asarray(scaling[1], dtype=np.float64)
        if ext.shape != freq.shape:
            raise ValueError(
                f"longrope factor list has {ext.shape[0]} entries for head_dim {head_dim} "
                f"(need {freq.shape[0]})"
            )
        freq = freq / ext
    else:
        raise NotImplementedError(f"rope scaling kind {kind!r}")
    return freq.astype(np.float32)


def rope_attention_scale(scaling: tuple | None) -> float:
    """The factor HF applies to the cos/sin tables: yarn's and longrope's
    attention factor, 1.0 for every other kind."""
    if scaling is not None and scaling[0] == "yarn":
        return float(scaling[5])
    if scaling is not None and scaling[0] == "longrope":
        return float(scaling[4])
    return 1.0


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float, scaling: tuple | None = None,
    total_len: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer positions [..., L] -> float32 (cos, sin) [..., L, head_dim//2].
    ``scaling``: ``LlamaConfig.rope_scaling_spec``. ``total_len`` (longrope
    only, required there): the real sequence length, a scalar or a tensor
    over the leading dims of ``positions`` ([B] for positions [B, ..., L]);
    above the original context length the long factors apply, else the
    short ones, per sequence."""
    dev = positions.device
    if scaling is not None and scaling[0] == "longrope":
        (_, long_f, short_f, orig_max, _af) = scaling
        if total_len is None:
            raise ValueError(
                "longrope rope scaling requires total_len (the real sequence length) to choose "
                "the long/short factor table"
            )
        f_long = torch.from_numpy(_inv_freq(head_dim, float(theta), ("longrope_ext", long_f))).to(dev)
        f_short = torch.from_numpy(_inv_freq(head_dim, float(theta), ("longrope_ext", short_f))).to(dev)
        is_long = torch.as_tensor(total_len, device=dev) > orig_max
        is_long = is_long.reshape(*is_long.shape, *(1,) * (positions.ndim - is_long.ndim), 1)
        freqs = torch.where(is_long, f_long, f_short)
    else:
        freqs = torch.from_numpy(_inv_freq(head_dim, float(theta), scaling)).to(dev)
    angles = positions.to(torch.float32)[..., None] * freqs
    att = rope_attention_scale(scaling)
    if att != 1.0:
        return torch.cos(angles) * att, torch.sin(angles) * att
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q/k. x: [..., L, n_heads, head_dim]; cos/sin: [..., L, head_dim//2]
    (broadcast over the heads axis). Half-split form of HF's rotate_half."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :].to(x.dtype)
    s = sin[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The complex-pair rotation (DeepSeek's rope_interleave): adjacent
    (even, odd) dims form each pair, computed in float32 and cast back."""
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


__all__ = ["apply_rope", "apply_rope_interleaved", "rope_attention_scale", "rope_cos_sin"]
