"""RMSNorm (counterpart of scalellm_tpu/layers/norms.py:rms_norm).

Computed in float32 and cast back to the input dtype.
"""

from __future__ import annotations

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
