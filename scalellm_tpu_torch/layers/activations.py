"""Activations (counterpart of scalellm_tpu/layers/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACT2FN = {
    "silu": F.silu,
}


def act_with_mul(name: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """act(gate) * up — the gated-MLP elementwise step."""
    act = ACT2FN.get(name)
    if act is None:
        raise NotImplementedError(f"activation {name!r} is not ported")
    return act(gate) * up
