"""RMSNorm with HF ``LlamaRMSNorm`` numerics (the JAX package's
``ops/norm.py``): variance in float32, the scale multiply in the input
dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """y = scale * x / sqrt(mean(x^2) + eps), variance computed in float32."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return scale * normed.to(x.dtype)


__all__ = ["rms_norm"]
