"""RMSNorm with HF ``LlamaRMSNorm`` numerics (the JAX package's
``ops/norm.py``): variance in float32, the scale multiply in the input
dtype — or, in the Gemma form, by (1 + scale) in float32 before the
downcast."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    """y = scale * x / sqrt(mean(x^2) + eps), variance computed in float32.
    ``unit_offset`` is the Gemma convention (HF PR #29402): multiply by
    (1 + scale) in float32, then cast to the input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    if unit_offset:
        return (normed * (1.0 + scale.float())).to(x.dtype)
    return scale * normed.to(x.dtype)


__all__ = ["rms_norm"]
