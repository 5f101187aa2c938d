"""RMSNorm and LayerNorm (counterparts of scalellm_tpu/layers/norms.py).

Computed in float32 and cast back to the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, zero_centered: bool = False
) -> torch.Tensor:
    """RMSNorm; zero_centered uses (1 + w) weights (gemma convention)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if zero_centered:
        w = 1.0 + w
    return (xf * w).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    """LayerNorm with an optional bias: f32 mean and variance, the weight,
    then the bias, then the cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
