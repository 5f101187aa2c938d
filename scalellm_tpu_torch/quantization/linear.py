"""Weight rules of quantized checkpoints (counterpart of
scalellm_tpu/quantization/linear.py).

Turns a model's dense weight rules into rules that match the AWQ/GPTQ tensor
names (qweight / qzeros / scales / g_idx) and attach the transforms that
produce the kernel layout of ops/quant_matmul.py. The transforms are torch
ops, so the loader can run them on the device the weights go to.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from scalellm_tpu_torch.config import QuantArgs
from scalellm_tpu_torch.ops.quant_matmul import pack_int4, to_kernel_layout
from scalellm_tpu_torch.quantization.formats import (
    unpack_awq_tensor,
    unpack_awq_zeros,
    unpack_gptq_zeros,
)

PROJ_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)

# 0x88888888 as an int32: flips bit 3 of every nibble, which turns an
# unsigned nibble u into the two's complement nibble of u - 8.
_SIGN_BITS = -0x77777778

Rule = Tuple[str, str, Optional[Callable[[torch.Tensor], torch.Tensor]]]


def gptq_qweight_to_kernel_layout(qweight: torch.Tensor) -> torch.Tensor:
    """GPTQ qweight i32 [K/8, N] -> kernel layout int8 [N, K/2]. A GPTQ word
    holds 8 consecutive K of one column, lowest nibble first, which is the
    kernel layout's byte order already: flip the nibbles' sign bits,
    transpose, and view the words as bytes. Equal to
    to_kernel_layout(pack_int4(unpack_gptq_tensor(qweight)))."""
    return (qweight.to(torch.int32) ^ _SIGN_BITS).T.contiguous().view(torch.int8)


def build_quant_rules(base_rules: List[Tuple], quant: QuantArgs) -> List[Rule]:
    """Rewrite the projections' `.weight` rules into qweight / qzeros /
    scales (and g_idx) rules with their transforms; other rules pass through
    with their own layout transform (the third element of a rule, None where
    it has two). A projection rule's layout transform is dropped: the
    checkpoint's qweight is [K/8, N] whatever the dense weight's layout."""
    method = quant.quant_method
    # "exllama"/"exllamav2" name kernels that read the GPTQ format.
    if method in ("exllama", "exllamav2"):
        method = "gptq"
    if method not in ("awq", "gptq"):
        raise ValueError(f"unsupported quant method {method!r}")
    if quant.bits != 4:
        raise ValueError("int4 checkpoints only (int8 through runtime quantization)")

    def qweight_transform(t: torch.Tensor) -> torch.Tensor:
        if method == "gptq":
            return gptq_qweight_to_kernel_layout(t)
        return to_kernel_layout(pack_int4(unpack_awq_tensor(t)))

    def zeros_transform(t: torch.Tensor) -> torch.Tensor:
        z = unpack_awq_zeros(t) if method == "awq" else unpack_gptq_zeros(t)
        # The kernel layout stores signed nibbles (value - 8): shift the
        # zero points to match.
        return (z.to(torch.int32) - 8).to(torch.int8)

    out: List[Rule] = []
    for rx, target, *layout in base_rules:
        is_proj = target.rsplit(".", 1)[-1] in PROJ_NAMES and rx.endswith(r"\.weight")
        if not is_proj:
            out.append((rx, target, layout[0] if layout else None))
            continue
        stem = rx[: -len(r"\.weight")]
        out.append((stem + r"\.qweight", target + ".qweight", qweight_transform))
        out.append((stem + r"\.qzeros", target + ".zeros", zeros_transform))
        out.append((stem + r"\.scales", target + ".scales", lambda t: t.to(torch.float32)))
        if quant.desc_act:
            # Rows stay in checkpoint order; g_idx[k] is row k's group. The
            # loader sorts rows into contiguous groups and keeps the
            # permutation for the input gather.
            out.append((stem + r"\.g_idx", target + ".g_idx", lambda t: t.to(torch.int32)))
    return out
