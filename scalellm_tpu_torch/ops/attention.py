"""Ragged paged attention: the dispatcher and the CUDA kernel's wrapper.

Counterpart of scalellm_tpu/ops/attention.py:ragged_paged_attention, which
calls the stock Pallas kernel on a TPU. Here a CUDA tensor goes to the
hand-written Hopper kernel of csrc/ragged_paged_attention.cu, and a CPU tensor
goes to the plain version (ops/attention_ref.py). There is no fallback from
one to the other: a CUDA call the kernel does not cover raises.

KV page layout: [num_pages, page_size, 2 * n_kv_heads, head_dim], K at even
combined-head indices, V at odd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

_MAX_GROUP = 16  # kMaxGroup in the kernel
_HEAD_DIMS = (64, 128)

# Parameters of the C entry point scalellm_ragged_paged_attention, in order:
# 7 pointers (q .. out), 7 ints (num_tokens .. head_dim), sm_scale, window,
# soft_cap, stream.
_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)


def _library() -> ctypes.CDLL:
    lib = _build.load("ragged_paged_attention")
    fn = lib.scalellm_ragged_paged_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def ragged_paged_attention_cuda(
    q: torch.Tensor,  # bf16 [T, n_heads, head_dim]
    kv_pages: torch.Tensor,  # bf16 [P, page_size, 2*n_kv_heads, head_dim]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, MAXP]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_seqs: torch.Tensor,  # i32[1]
    *,
    sm_scale: float = 1.0,
    sliding_window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream; returns bf16 [T, H, D].

    `ragged_paged_attention_cuda.launches` counts the launches."""
    T, n_heads, head_dim = q.shape
    if kv_pages.dim() != 4:
        raise ValueError(f"kv_pages must be 4-d, got {tuple(kv_pages.shape)}")
    _, page_size, h2, d2 = kv_pages.shape
    S, maxp = page_indices.shape
    n_kv_heads = h2 // 2
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    for name, t in (("kv_pages", kv_pages), ("kv_lens", kv_lens),
                    ("page_indices", page_indices), ("cu_q_lens", cu_q_lens),
                    ("num_seqs", num_seqs)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype != torch.bfloat16 or kv_pages.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA kernel takes bf16 q and pages, got {q.dtype}, {kv_pages.dtype}"
        )
    for name, t in (("kv_lens", kv_lens), ("page_indices", page_indices),
                    ("cu_q_lens", cu_q_lens), ("num_seqs", num_seqs)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if head_dim not in _HEAD_DIMS:
        raise NotImplementedError(f"head_dim {head_dim} (kernel takes {_HEAD_DIMS})")
    if d2 != head_dim or h2 % 2 or n_kv_heads == 0 or n_heads % n_kv_heads:
        raise ValueError(
            f"q {tuple(q.shape)} does not match kv_pages {tuple(kv_pages.shape)}"
        )
    if n_heads // n_kv_heads > _MAX_GROUP:
        raise NotImplementedError(f"GQA group {n_heads // n_kv_heads} > {_MAX_GROUP}")
    if kv_lens.shape != (S,) or cu_q_lens.shape != (S + 1,) or num_seqs.shape != (1,):
        raise ValueError("kv_lens, cu_q_lens and num_seqs must be [S], [S+1], [1]")

    out = torch.empty_like(q)
    rc = _library().scalellm_ragged_paged_attention(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(), cu_q_lens.data_ptr(), num_seqs.data_ptr(),
        out.data_ptr(), T, S, maxp, page_size, n_heads, n_kv_heads, head_dim,
        float(sm_scale), int(sliding_window or 0), float(logit_soft_cap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: CUDA error {rc}")
    ragged_paged_attention_cuda.launches += 1
    return out


ragged_paged_attention_cuda.launches = 0


def ragged_paged_attention(
    q: torch.Tensor,  # [T, n_heads, head_dim]
    kv_pages: torch.Tensor,  # [P, page_size, 2*n_kv_heads, head_dim]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_seqs: torch.Tensor,  # i32[1]
    *,
    sm_scale: float = 1.0,
    sliding_window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    k_scale: Optional[float] = None,
    v_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if q.device.type == "cpu":
        return ref_ragged_paged_attention(
            q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale=sm_scale, sliding_window=sliding_window,
            logit_soft_cap=logit_soft_cap, k_scale=k_scale, v_scale=v_scale,
            alibi_slopes=alibi_slopes,
        )
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 KV pages (k_scale/v_scale) are not ported")
    if alibi_slopes is not None:
        raise NotImplementedError("ALiBi attention is not ported")
    return ragged_paged_attention_cuda(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, sliding_window=sliding_window,
        logit_soft_cap=logit_soft_cap,
    )
