"""AWQ / GPTQ checkpoint unpacking (counterpart of
scalellm_tpu/quantization/formats.py, with torch ops so that it runs on the
device the weights are loaded to).

  AWQ   qweight i32 [K, N/8]: 8 nibbles along N, nibble i at column offset
        AWQ_ORDER[i]; qzeros i32 [K/G, N/8] packed the same; w = (q - z) * s
  GPTQ  qweight i32 [K/8, N]: 8 nibbles along K in order; qzeros i32
        [K/G, N/8] in order along N, storing z - 1; g_idx i32 [K] names each
        row's group (desc_act)
  Both  scales f16 [K/G, N]
"""

from __future__ import annotations

import torch

AWQ_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def _fields(packed: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """i32 -> a new dim after `dim` holding the 32/width bit fields of each
    word, lowest first, as int32."""
    n = 32 // width
    shape = [1] * (packed.dim() + 1)
    shape[dim + 1] = n
    shifts = (torch.arange(n, device=packed.device, dtype=torch.int32) * width).reshape(shape)
    return (packed.to(torch.int32).unsqueeze(dim + 1) >> shifts) & ((1 << width) - 1)


def _unpack_last_dim(packed: torch.Tensor, order, width: int = 4) -> torch.Tensor:
    """i32 [..., W] -> u8 [..., W * 32/width], field i of a word at column
    order[i] of its run."""
    f = _fields(packed, packed.dim() - 1, width)  # [..., W, n]
    inverse = [order.index(j) for j in range(len(order))]
    return f[..., inverse].reshape(*packed.shape[:-1], -1).to(torch.uint8)


def _unpack_first_dim(packed: torch.Tensor, width: int = 4) -> torch.Tensor:
    """i32 [R, N] -> u8 [R * 32/width, N], fields along dim 0 in order."""
    return _fields(packed, 0, width).reshape(-1, packed.shape[1]).to(torch.uint8)


def unpack_awq_tensor(qweight: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """AWQ qweight i32 [K, N/8] -> unsigned values u8 [K, N]."""
    assert bits == 4, "AWQ int4 only"
    return _unpack_last_dim(qweight, AWQ_ORDER)


def unpack_awq_zeros(qzeros: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """AWQ qzeros i32 [K/G, N/8] -> zero points i8 [K/G, N]."""
    assert bits == 4
    return _unpack_last_dim(qzeros, AWQ_ORDER).to(torch.int8)


def unpack_gptq_tensor(qweight: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """GPTQ qweight i32 [K/8, N] (int8: [K/4, N]) -> unsigned values u8 [K, N]."""
    assert bits in (4, 8)
    return _unpack_first_dim(qweight, bits)


def unpack_gptq_zeros(qzeros: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """GPTQ qzeros i32 [K/G, N/8] -> zero points i8 [K/G, N] (with the +1)."""
    z = _unpack_last_dim(qzeros, list(range(32 // bits)), bits)
    return (z.to(torch.int32) + 1).to(torch.int8)
