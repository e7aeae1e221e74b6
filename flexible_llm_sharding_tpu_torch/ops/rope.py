"""Rotary position embeddings without scaling, with HF Llama semantics (the
JAX package's ``ops/rope.py``): the angle table in float32 from frequencies
computed in float64 on the host, the rotation in the activation dtype."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float) -> np.ndarray:
    freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    return freq.astype(np.float32)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer positions [..., L] -> float32 (cos, sin) [..., L, head_dim//2]."""
    freqs = torch.from_numpy(_inv_freq(head_dim, float(theta))).to(positions.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q/k. x: [..., L, n_heads, head_dim]; cos/sin: [..., L, head_dim//2]
    (broadcast over the heads axis). Half-split form of HF's rotate_half."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :].to(x.dtype)
    s = sin[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


__all__ = ["apply_rope", "rope_cos_sin"]
