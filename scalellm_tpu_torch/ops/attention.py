"""Ragged paged attention: the dispatcher, the CUDA kernel's wrapper and the
plain versions.

Counterpart of scalellm_tpu/ops/attention.py:ragged_paged_attention, which
calls the stock Pallas kernel on a TPU. Here a CUDA tensor goes to the
hand-written Hopper kernel of csrc/ragged_paged_attention.cu, and a CPU tensor
goes to the plain version (ops/attention_ref.py). There is no fallback from
one to the other: a CUDA call the kernel does not cover raises.

The bf16 kernel takes every step the same way: each sequence of one token
(every slot of a decode step) has its KV range cut into the pieces
split_kv_plan() sizes from shapes the host knows, each piece gives f32
partials, and a merge adds them in split order (split-KV); a sequence of 2
or more tokens goes in q tiles of up to 64 rows (tokens x GQA group) on the
tensor cores. Head dims 64, 80 (Phi-2's), 128 and 256 (Gemma's; the
reference computes that one with its jnp reference, since its stock kernel
refuses head dims above 128, so the kernel is held to the plain version
there too). ALiBi slopes (MPT, BLOOM; f32 [n_heads] on the device) go to
the kernel; the reference sends ALiBi to its jnp path, so there too the
kernel is held to the plain version. f32 q and pages (GPT-2's float32
checkpoints) go to the CUDA-core kernel of csrc/ragged_paged_attention_f32.cu
(no TF32), which takes the same contract in one launch.
int8 pages (kv_cache_dtype="int8") go to both kernels with their static
k_scale and v_scale: each element is read as (int8 -> f32) * scale in q's
type, as the stock kernel reads them (the bf16 kernel rounds it to bf16; the
plain version keeps the f32 product, the JAX reference's form: the two agree
exactly at the scale of 1.0 that DecoderModel passes).
The dispatcher takes the engine's decode_only and ignores it, as the
reference's dispatcher does.
plain_split_kv_attention is the plain version of the split-and-merge: what
the CPU tests check the merge algebra with, and, with a piece left out,
the planted fault that shows the kernel checks can catch a lost piece.
Nothing on the main path calls it.

KV page layout: [num_pages, page_size, 2 * n_kv_heads, head_dim], K at even
combined-head indices, V at odd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

_MAX_GROUP = 16  # kMaxGroup in the kernels
_HEAD_DIMS = (64, 80, 128, 256)
KV_STAGE = 64  # kStage in the kernel: KV rows a ring stage; splits are multiples of it
BLOCKS_PER_SM = 2  # split blocks an SM the plan aims at, at the block table's length
MAX_SPLIT_LEN = 512  # rows: so that contexts of unequal length balance over the blocks
H100_SMS = 132

# The int8 pages' flag and scales: kv_int8, k_scale, v_scale.
_INT8_ARGTYPES = [ctypes.c_int, ctypes.c_float, ctypes.c_float]
# Parameters of the C entry point scalellm_ragged_paged_attention, in order:
# 9 pointers (q .. scratch, alibi_slopes), 9 ints (num_tokens .. split_len),
# sm_scale, window, soft_cap, kv_int8, k_scale, v_scale, stream.
_ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + _INT8_ARGTYPES + [ctypes.c_void_p]
)
# scalellm_ragged_paged_attention_f32: 8 pointers (q .. out, alibi_slopes),
# 7 ints (num_tokens .. head_dim), sm_scale, window, soft_cap, kv_int8,
# k_scale, v_scale, stream.
_F32_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + _INT8_ARGTYPES + [ctypes.c_void_p]
)


def _bind(name: str, entry: str, argtypes):
    """The C entry point `entry` of kernel `name` (built on first use), with
    its argtypes."""
    fn = getattr(_build.load(name), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_kv_plan(kv_capacity: int, n_slots: int, n_kv_heads: int, n_sm: int = H100_SMS) -> Tuple[int, int]:
    """(splits, split_len) of the split path: a slot's KV range is cut into
    `splits` pieces of `split_len` rows, a multiple of KV_STAGE. Sized from
    what the host knows, never from a device value: the block table's
    length kv_capacity = maxp * page_size (the longest context it allows),
    the slots, the KV heads and the SM count, so that a batch whose every
    slot reached kv_capacity would give about BLOCKS_PER_SM blocks an SM,
    and no piece is longer than MAX_SPLIT_LEN rows (a batch of unequal
    contexts then spreads its long ones over more blocks)."""
    stages = max(1, -(-kv_capacity // KV_STAGE))
    want = max(1, -(-BLOCKS_PER_SM * n_sm // max(1, n_slots * n_kv_heads)),
               -(-kv_capacity // MAX_SPLIT_LEN))
    per_split = -(-stages // min(want, stages))
    return -(-stages // per_split), per_split * KV_STAGE


def _check_operands(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, alibi_slopes=None):
    """The kernel's operand checks; returns (T, S, maxp, page_size, n_heads,
    n_kv_heads, head_dim)."""
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
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned (the kernel copies 16 bytes at a time)")
    if q.dtype not in (torch.bfloat16, torch.float32) or kv_pages.dtype not in (q.dtype, torch.int8):
        raise NotImplementedError(
            f"the CUDA kernels take bf16 or f32 q with pages of its type or int8, got {q.dtype}, {kv_pages.dtype}"
        )
    if kv_pages.data_ptr() % 16:
        raise ValueError("kv_pages must be 16-byte aligned (the kernel copies 16 bytes at a time)")
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
    if alibi_slopes is not None and (
            alibi_slopes.dtype != torch.float32 or alibi_slopes.shape != (n_heads,)
            or alibi_slopes.device != q.device or not alibi_slopes.is_contiguous()):
        raise ValueError(f"alibi_slopes must be a contiguous f32 [{n_heads}] tensor on {q.device}")
    return T, S, maxp, page_size, n_heads, n_kv_heads, head_dim


class LaunchCount:
    """A count of one kind of the wrapper's launches, read and reset like a
    wrapper's own `launches`."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def ragged_paged_attention_cuda(
    q: torch.Tensor,  # bf16 or f32 [T, n_heads, head_dim]
    kv_pages: torch.Tensor,  # q's dtype [P, page_size, 2*n_kv_heads, head_dim]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, MAXP]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_seqs: torch.Tensor,  # i32[1]
    *,
    sm_scale: float = 1.0,
    sliding_window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # f32[n_heads]
    k_scale: Optional[float] = None,
    v_scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (bf16: the attention
    grid and its merge; f32: the CUDA-core kernel); returns [T, H, D] in
    q's dtype. int8 pages are read as (int8 -> f32) * k_scale (K) or
    v_scale (V) in q's type (a scale of None reads 1.0); pages of q's type
    take no scales.

    `ragged_paged_attention_cuda.launches` counts the calls that launched;
    `.alibi`, `.d80`, `.f32` and `.int8` (LaunchCount) count those with
    ALiBi slopes, at head dim 80, in f32 and on int8 pages."""
    T, S, maxp, page_size, n_heads, n_kv_heads, head_dim = _check_operands(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, alibi_slopes)
    int8 = kv_pages.dtype == torch.int8
    if not int8 and (k_scale is not None or v_scale is not None):
        raise NotImplementedError("k_scale/v_scale scale int8 pages; the kernels read float pages as they are")
    scales = (int(int8), 1.0 if k_scale is None else float(k_scale), 1.0 if v_scale is None else float(v_scale))
    out = torch.empty_like(q)
    alibi = alibi_slopes.data_ptr() if alibi_slopes is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.float32:
        rc = _bind("ragged_paged_attention_f32", "scalellm_ragged_paged_attention_f32", _F32_ARGTYPES)(
            q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
            cu_q_lens.data_ptr(), num_seqs.data_ptr(), out.data_ptr(), alibi, T, S, maxp, page_size,
            n_heads, n_kv_heads, head_dim, float(sm_scale), int(sliding_window or 0),
            float(logit_soft_cap or 0.0), *scales, stream)
    else:
        splits, split_len = split_kv_plan(maxp * page_size, S, n_kv_heads, _sm_count(q.device))
        # The split path's f32 partials: o [S, splits, H, D], then (m, l) [S, splits, H].
        scratch = torch.empty(S * splits * n_heads * (head_dim + 2), dtype=torch.float32, device=q.device)
        rc = _bind("ragged_paged_attention", "scalellm_ragged_paged_attention", _ARGTYPES)(
            q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
            page_indices.data_ptr(), cu_q_lens.data_ptr(), num_seqs.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), alibi, T, S, maxp, page_size, n_heads, n_kv_heads,
            head_dim, splits, split_len,
            float(sm_scale), int(sliding_window or 0), float(logit_soft_cap or 0.0), *scales, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: CUDA error {rc}")
    ragged_paged_attention_cuda.launches += 1
    for kind, on in ((ragged_paged_attention_cuda.alibi, alibi_slopes is not None),
                     (ragged_paged_attention_cuda.d80, head_dim == 80),
                     (ragged_paged_attention_cuda.f32, q.dtype == torch.float32),
                     (ragged_paged_attention_cuda.int8, int8)):
        kind.launches += on
    return out


ragged_paged_attention_cuda.launches = 0
ragged_paged_attention_cuda.alibi = LaunchCount("ragged_paged_attention_alibi")
ragged_paged_attention_cuda.d80 = LaunchCount("ragged_paged_attention_d80")
ragged_paged_attention_cuda.f32 = LaunchCount("ragged_paged_attention_f32")
ragged_paged_attention_cuda.int8 = LaunchCount("ragged_paged_attention_int8")


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
    decode_only: bool = False,
) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor.
    decode_only changes nothing: a decode step's slots take the split-KV
    blocks because each has one token."""
    del decode_only
    if q.device.type == "cpu":
        return ref_ragged_paged_attention(
            q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale=sm_scale, sliding_window=sliding_window,
            logit_soft_cap=logit_soft_cap, k_scale=k_scale, v_scale=v_scale,
            alibi_slopes=alibi_slopes,
        )
    return ragged_paged_attention_cuda(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, sliding_window=sliding_window,
        logit_soft_cap=logit_soft_cap, alibi_slopes=alibi_slopes, k_scale=k_scale, v_scale=v_scale,
    )


def plain_ragged_paged_attention(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
                                 sm_scale=1.0, sliding_window=None, logit_soft_cap=None,
                                 k_scale=None, v_scale=None, alibi_slopes=None,
                                 decode_only=False):
    """The plain version on whatever device q lies, under the signature of
    the model's attention hook: what the kernel is held against on the
    card. decode_only changes nothing here (the contract is the same)."""
    del decode_only
    return ref_ragged_paged_attention(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, sliding_window=sliding_window, logit_soft_cap=logit_soft_cap,
        k_scale=k_scale, v_scale=v_scale, alibi_slopes=alibi_slopes,
    )


def plain_split_kv_attention(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
                             sm_scale=1.0, sliding_window=None, logit_soft_cap=None, alibi_slopes=None,
                             k_scale=None, v_scale=None, drop: Optional[Tuple[int, int]] = None):
    """The split path's arithmetic in plain PyTorch, for a decode-only batch
    (slot s's one token at row s): each slot's KV range is cut into the
    pieces split_kv_plan() gives on an H100, each piece gives (o, m, l) in
    f32 (an empty piece gives m = -inf, l = 0), and the pieces merge in
    split order. ALiBi slopes add slope * (kv_pos - pos) after the scale.
    int8 pages are read as the bf16 kernel reads them: (int8 * scale)
    rounded to q's type.
    Rows that own no KV (rows past S or past cu_q_lens[num_seqs], slots
    with kv_len 0) are zeros. Returns [T, H, D] in q's dtype.
    drop = (slot, piece) leaves that piece out of the merge: a planted
    fault, the output of a merge that lost a piece, for the tests that show
    the kernel checks catch one."""
    T, n_heads, D = q.shape
    S, maxp = page_indices.shape
    page_size = kv_pages.shape[1]
    n_kv_heads = kv_pages.shape[2] // 2
    group = n_heads // n_kv_heads
    capacity = maxp * page_size
    splits, split_len = split_kv_plan(capacity, S, n_kv_heads)
    n_real = min(max(int(num_seqs[0]), 0), S)
    n_tok = int(cu_q_lens[n_real])
    out = torch.zeros(T, n_heads, D, dtype=torch.float32, device=q.device)
    for s in range(min(S, T, n_tok)):
        kv_len = int(kv_lens[s])
        pos = kv_len - 1
        lo = max(0, pos - sliding_window + 1) if sliding_window and sliding_window > 0 else 0
        hi = min(kv_len, capacity)
        rows = kv_pages[page_indices[s].long()].reshape(capacity, 2 * n_kv_heads, D).float()
        k, v = rows[:, 0::2], rows[:, 1::2]  # [capacity, Hkv, D]
        if kv_pages.dtype == torch.int8:
            k = (k * (1.0 if k_scale is None else k_scale)).to(q.dtype).float()
            v = (v * (1.0 if v_scale is None else v_scale)).to(q.dtype).float()
        qs = q[s].float().reshape(n_kv_heads, group, D)
        o_run = torch.zeros(n_kv_heads, group, D, dtype=torch.float32, device=q.device)
        m_run = torch.full((n_kv_heads, group), float("-inf"), device=q.device)
        l_run = torch.zeros(n_kv_heads, group, device=q.device)
        for sp in range(splits):
            a, b = max(lo, sp * split_len), min(hi, (sp + 1) * split_len)
            if b <= a or drop == (s, sp):
                continue  # an empty piece: l = 0 leaves the merge as it is
            sc = torch.einsum("hgd,jhd->hgj", qs, k[a:b]) * sm_scale
            if alibi_slopes is not None:
                dist = torch.arange(a, b, device=q.device).float() - pos
                sc = sc + alibi_slopes.float().reshape(n_kv_heads, group, 1) * dist
            if logit_soft_cap is not None and logit_soft_cap > 0.0:
                sc = logit_soft_cap * torch.tanh(sc / logit_soft_cap)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            l = p.sum(-1)
            o = torch.einsum("hgj,jhd->hgd", p, v[a:b])
            m_new = torch.maximum(m_run, m)
            alpha, w = torch.exp(m_run - m_new), torch.exp(m - m_new)
            o_run = o_run * alpha[..., None] + o * w[..., None]
            l_run = l_run * alpha + l * w
            m_run = m_new
        inv = torch.where(l_run > 0, 1.0 / l_run.clamp_min(1e-30), torch.zeros_like(l_run))
        out[s] = (o_run * inv[..., None]).reshape(n_heads, D)
    return out.to(q.dtype)
