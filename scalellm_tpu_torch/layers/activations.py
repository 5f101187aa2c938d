"""Activations (counterpart of scalellm_tpu/layers/activations.py): the
reference's whole table. HF's "gelu" is the exact erf form; "gelu_fast",
"gelu_new" and "gelu_pytorch_tanh" are the tanh approximation."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

ACT2FN = {
    "silu": F.silu,
    "gelu": F.gelu,
    "gelu_fast": functools.partial(F.gelu, approximate="tanh"),
    "gelu_new": functools.partial(F.gelu, approximate="tanh"),
    "gelu_pytorch_tanh": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


def act_with_mul(name: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """act(gate) * up — the gated-MLP elementwise step."""
    return ACT2FN[name](gate) * up
