"""Grouped GEMM over expert-sorted rows (K6): the plain version, the CUDA
kernel's wrapper and the dispatcher.

Counterpart of scalellm_tpu/layers/moe.py:_grouped_matmul, which calls the
stock megablox `gmm` Pallas kernel on a TPU. Rows of xs [R, K] are sorted by
expert: rows [off_e, off_e + group_sizes[e]) belong to expert e. Each group
is multiplied by its expert's weight; the weights are stored [E, N, K]
(torch's [out, in] layout per expert). The result is f32 [R, N]. Rows at or
past sum(group_sizes) are uncovered: the kernel leaves them unwritten and
the caller masks them (the plain version gives zeros there).

A CUDA tensor goes to the Hopper kernel of csrc/grouped_matmul.cu, a CPU
tensor to the plain version. There is no fallback from one to the other: a
CUDA call the kernel does not cover raises.
"""

from __future__ import annotations

import ctypes

import torch

from scalellm_tpu_torch.ops import _build


def plain_grouped_matmul(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """A loop over the experts: group e's rows times w[e]^T, in f32 (bf16
    products are exact in f32; the sums run in another order than the
    kernel's)."""
    R = xs.shape[0]
    out = torch.zeros(R, w.shape[1], dtype=torch.float32, device=xs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + max(size, 0), R)
        if end > start:
            out[start:end] = xs[start:end].float() @ w[e].float().T
        start = end
    return out


# ---------------------------------------------------------------- CUDA wrapper

_P, _I = ctypes.c_void_p, ctypes.c_int
# Parameters of scalellm_grouped_matmul in csrc/grouped_matmul.cu, in order:
# xs, w, group_sizes, out; R, K, N, E, tile; stream.
ENTRY_POINTS = {"scalellm_grouped_matmul": [_P] * 4 + [_I] * 5 + [_P]}
# The kernel's block shapes, as (weight rows, tokens): `tile` i is TILES[i].
TILES = ((64, 16), (128, 64))


def tile_for(R: int, E: int) -> int:
    """The block shape for R expert-sorted rows over E experts, from shapes
    alone (no host sync): 64 weight rows x 16 tokens while the average
    expert has at most 8 rows (decode: an expert of 1-3 rows wastes little
    of the token tile, and small items spread the weights over the SMs),
    else 128 x 64 (prefill: 48 rows an expert at DeepSeek-V2-Lite's T =
    512, where most experts fit one token tile)."""
    return 0 if R <= 8 * E else 1


def _library() -> ctypes.CDLL:
    lib = _build.load("grouped_matmul")
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def grouped_matmul_cuda(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                        tile: int | None = None) -> torch.Tensor:
    """Launch the grouped GEMM kernel on the current stream; returns f32
    [R, N] with uncovered rows unwritten. tile (an index into TILES)
    defaults to tile_for(R, E). `grouped_matmul_cuda.launches` counts the
    launches."""
    if xs.device.type != "cuda":
        raise ValueError(f"xs must be a CUDA tensor, got {xs.device}")
    if xs.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(f"the grouped GEMM kernel takes bf16 xs and w, got {xs.dtype}, {w.dtype}")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    for name, t in (("xs", xs), ("w", w), ("group_sizes", group_sizes)):
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    R, K = xs.shape
    E, N, Kw = w.shape
    if Kw != K or group_sizes.shape != (E,):
        raise ValueError(f"xs {tuple(xs.shape)}, w {tuple(w.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} do not match")
    if K % 32 or N % 8 or E * N >= 2**31:
        raise NotImplementedError(f"the grouped GEMM kernel needs K % 32 == 0, N % 8 == 0 and E * N < 2^31; "
                                  f"got K={K}, N={N}, E={E}")
    if tile is None:
        tile = tile_for(R, E)
    elif tile not in range(len(TILES)):
        raise ValueError(f"tile must index TILES {TILES}, got {tile}")
    out = torch.empty(R, N, dtype=torch.float32, device=xs.device)
    rc = _library().scalellm_grouped_matmul(
        xs.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), R, K, N, E, tile,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"grouped matmul kernel launch failed: CUDA error {rc}")
    grouped_matmul_cuda.launches += 1
    return out


grouped_matmul_cuda.launches = 0


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """xs [R, K] sorted by expert, w [E, N, K], group_sizes i32[E] -> f32
    [R, N]: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if xs.device.type == "cpu":
        return plain_grouped_matmul(xs, w, group_sizes)
    return grouped_matmul_cuda(xs, w, group_sizes)
