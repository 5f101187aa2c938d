"""MLA latent attention over a K-only page cache: the latent scatter, the
reference, the plain versions of the two kernels, their CUDA wrappers and
the dispatcher.

Counterpart of scalellm_tpu/ops/mla_attention.py. DeepSeek's absorbed MLA
is multi-query attention over one shared latent head K = [c_kv | k_pe]
(kv_lora_rank + rope dims, 576 for DeepSeek-V2); V is the first v_dim
columns of the same rows, so the pages hold K only: [P, page_size, 1, Dc].

  - set_latent_cache: scatter the new tokens' latent rows into the pages,
    in place. Slots in page 0 (the reserved padding page) take the padding
    tokens' writes.
  - ref_mla_paged_attention: a transcription of the JAX reference (ground
    truth; gathers [T, MAXP * page_size, Dc]).
  - plain_mla_decode / plain_mla_prefill: plain PyTorch versions of the two
    kernels, what the CPU runs and what the kernels are held to on the card.
  - mla_split_plan: the pieces a 1-token sequence's latent range is cut
    into (split-KV), from shapes the host knows;
    plain_mla_split_decode: the split-and-merge in plain PyTorch under that
    plan, for the CPU tests and, with a piece left out, the planted fault
    that shows the kernel checks catch a lost piece. Nothing on the main
    path calls it.
  - mla_decode_attention_cuda (K9, the counterpart of _mla_decode_kernel)
    and mla_prefill_attention_cuda (K10, of _mla_prefill_kernel): wrappers
    of the Hopper kernels in csrc/mla_attention.cu, each counting its
    launches. Both launch one attention grid and a merge: every sequence of
    one token takes split blocks (f32 partials in a scratch the wrapper
    allocates, merged in split order), every longer one (K10) q tiles of
    TILE_TOKENS tokens.
  - mla_paged_attention: the dispatcher. A CUDA tensor goes to K9 for a
    decode-only batch (one token per sequence slot, token s of sequence s)
    and to K10 otherwise; a CPU tensor goes to the plain versions. There is
    no fallback from one to the other: a CUDA call the kernels do not cover
    raises.

Rows that own no KV come out as zeros: padding sequence slots (kv_len 0),
rows past the sequence slots of a decode-only batch, and rows at or past
cu_q_lens[num_seqs] of a mixed batch.

int8 latent pages (kv_cache_dtype="int8"): set_latent_cache stores
round(x / scale) clamped to [-127, 127], and the kernels read each element
as (int8 -> f32) * k_scale rounded to bf16, as the reference's Pallas kernels
do (scalellm_tpu/ops/mla_attention.py:175-177, :355-357); so do the plain
versions, which, as the kernels, take k_scale with int8 pages only.
ref_mla_paged_attention keeps the f32 product (the JAX reference's form);
the two agree exactly where int8 * k_scale is a bf16 value, as at the
reference's default scale of 1/16.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops.attention import H100_SMS, LaunchCount, _sm_count

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# The kernels are built for DeepSeek-V2's widths (V2, V2-Lite and V3 alike):
# kv_lora_rank 512 plus 64 rope dims.
KERNEL_LATENT_DIM, KERNEL_V_DIM = 576, 512
HEAD_GROUP = 16  # kHeads in the kernel: query heads a block, the mma M tile
MLA_STEP = 64  # kStep in the kernel: latent rows a step; pieces are whole steps
MLA_BLOCKS_PER_SM = 2  # split blocks an SM the plan aims at, at the block table's length
MLA_MAX_SPLIT_LEN = 256  # rows: so that contexts of unequal length balance over the blocks
TILE_TOKENS = 2  # kTileTokens in the kernel: tokens of a K10 tile block


def set_latent_cache(
    k_pages: torch.Tensor,  # [P, page_size, 1, Dc]
    k_lat: torch.Tensor,  # [T, Dc] latent rows [c_kv | k_pe]
    slot_ids: torch.Tensor,  # [T] global slot ids
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scatter k_lat into k_pages in place (int8 pages: round(x / scale)
    clamped to [-127, 127]); returns k_pages."""
    if k_pages.dtype == torch.int8:
        k_lat = torch.round(k_lat.float() / scale).clamp(-127, 127)
    P, page_size, one, Dc = k_pages.shape
    flat = k_pages.view(P * page_size, Dc)
    flat.index_copy_(0, slot_ids.long(), k_lat.to(k_pages.dtype))
    return k_pages


def ref_mla_paged_attention(
    q: torch.Tensor,  # [T, H, Dc]
    k_pages: torch.Tensor,  # [P, page_size, 1, Dc]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, MAXP]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_seqs: torch.Tensor,  # i32[1] (unused: padding rows fully masked)
    *,
    sm_scale: float,
    v_dim: int,
    k_scale: Optional[float] = None,
) -> torch.Tensor:  # [T, H, v_dim]
    """The JAX reference, op for op: every token attends its sequence's
    whole [MAXP * page_size] latent rows, masked causally by absolute
    position and by kv_len."""
    T, H, Dc = q.shape
    S, MAXP = page_indices.shape
    page_size = k_pages.shape[1]
    KV = MAXP * page_size
    dev = q.device
    tok = torch.arange(T, device=dev, dtype=torch.int32)
    token_seg = torch.searchsorted(cu_q_lens[1:].contiguous(), tok, right=True).clamp(0, S - 1)
    q_lens = cu_q_lens[1:] - cu_q_lens[:-1]
    positions = kv_lens[token_seg] - q_lens[token_seg] + (tok - cu_q_lens[token_seg])

    k_seq = k_pages[page_indices.long()].reshape(S, KV, Dc)
    k_tok = k_seq[token_seg].float()  # [T, KV, Dc]
    if k_scale is not None:
        k_tok = k_tok * k_scale
    v_tok = k_tok[..., :v_dim]
    scores = torch.einsum("thd,tjd->thj", q.float(), k_tok) * sm_scale
    kv_pos = torch.arange(KV, device=dev, dtype=torch.int32)
    mask = kv_pos[None, :] > positions[:, None]
    mask = mask | (kv_pos[None, :] >= kv_lens[token_seg][:, None])
    scores = scores.masked_fill(mask[:, None, :], MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("thj,tjd->thd", p, v_tok).to(q.dtype)


def _widen(k: torch.Tensor, k_scale: Optional[float], dtype: torch.dtype) -> torch.Tensor:
    """Latent rows as the kernels read them: int8 pages (int8 -> f32) *
    k_scale rounded to q's type; float pages as they are. k_scale scales
    int8 pages only, as in the kernels."""
    if k.dtype == torch.int8:
        return (k.float() * (1.0 if k_scale is None else k_scale)).to(dtype)
    if k_scale is not None:
        raise NotImplementedError("k_scale scales int8 latent pages; float pages are read as they are")
    return k


def _attend(q: torch.Tensor, k: torch.Tensor, kv_end: torch.Tensor, sm_scale: float, v_dim: int):
    """Softmax attention of q [n, H, Dc] over latent rows k ([KV, Dc] shared
    by all rows, or [n, KV, Dc]) where row i sees k[:kv_end[i]]; rows that
    see nothing give zeros. f32 throughout."""
    kf = k.float()
    scores = (q.float() @ kf.transpose(-1, -2)) * sm_scale  # [n, H, KV]
    visible = torch.arange(k.shape[-2], device=q.device)[None, :] < kv_end[:, None]
    scores = scores.masked_fill(~visible[:, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True).clamp_min(MASK_VALUE)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = p @ kf[..., :v_dim]
    return torch.where(l > 0, out / l.clamp_min(1e-30), torch.zeros_like(out))


def plain_mla_decode(
    q: torch.Tensor,  # [T, H, Dc], T >= S: token s is sequence s's only query
    k_pages: torch.Tensor,  # [P, page_size, 1, Dc]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, MAXP]
    *,
    sm_scale: float,
    v_dim: int,
    k_scale: Optional[float] = None,
) -> torch.Tensor:  # [T, H, v_dim]
    """Plain version of the decode kernel (K9): one query per sequence slot
    over its first kv_len latent rows; rows past the S slots and slots with
    kv_len 0 are zeros."""
    T, H, Dc = q.shape
    S, MAXP = page_indices.shape
    k = _widen(k_pages[page_indices.long()].reshape(S, MAXP * k_pages.shape[1], Dc), k_scale, q.dtype)
    out = torch.zeros(T, H, v_dim, dtype=q.dtype, device=q.device)
    out[:S] = _attend(q[:S], k, kv_lens.long(), sm_scale, v_dim).to(q.dtype)
    return out


def plain_mla_prefill(
    q: torch.Tensor,  # [T, H, Dc] ragged mixed prefill/decode batch
    k_pages: torch.Tensor,  # [P, page_size, 1, Dc]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, MAXP]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_seqs: torch.Tensor,  # i32[1]
    *,
    sm_scale: float,
    v_dim: int,
    k_scale: Optional[float] = None,
) -> torch.Tensor:  # [T, H, v_dim]
    """Plain version of the ragged prefill kernel (K10): sequence by
    sequence, token i of a chunk of q_len attends its context's rows
    [0, kv_len - q_len + i]. Rows outside every real chunk are zeros."""
    T, H, Dc = q.shape
    page_size = k_pages.shape[1]
    out = torch.zeros(T, H, v_dim, dtype=q.dtype, device=q.device)
    cu = cu_q_lens.tolist()
    lens = kv_lens.tolist()
    for s in range(int(num_seqs.reshape(-1)[0])):
        start, end, kv_len = cu[s], cu[s + 1], lens[s]
        if end <= start or kv_len <= 0:
            continue
        n_pages = -(-kv_len // page_size)
        k = _widen(k_pages[page_indices[s, :n_pages].long()].reshape(n_pages * page_size, Dc), k_scale, q.dtype)
        kv_end = torch.arange(kv_len - (end - start) + 1, kv_len + 1, device=q.device)
        out[start:end] = _attend(q[start:end], k, kv_end, sm_scale, v_dim).to(q.dtype)
    return out


def mla_split_plan(kv_capacity: int, n_slots: int, n_head_groups: int,
                   n_sm: int = H100_SMS) -> Tuple[int, int]:
    """(splits, split_len) of the split blocks: a 1-token sequence's latent
    range is cut into `splits` pieces of `split_len` rows, a multiple of
    MLA_STEP. Sized from what the host knows, never from a device value: the
    block table's length kv_capacity = maxp * page_size (the longest context
    it allows), the slots, the head groups and the SM count, so that a batch
    whose every slot reached kv_capacity would give about MLA_BLOCKS_PER_SM
    blocks an SM, and no piece is longer than MLA_MAX_SPLIT_LEN rows."""
    steps = max(1, -(-kv_capacity // MLA_STEP))
    want = max(1, -(-MLA_BLOCKS_PER_SM * n_sm // max(1, n_slots * n_head_groups)),
               -(-kv_capacity // MLA_MAX_SPLIT_LEN))
    per_split = -(-steps // min(want, steps))
    return -(-steps // per_split), per_split * MLA_STEP


def plain_mla_split_decode(
    q: torch.Tensor,  # [T, H, Dc], T >= S: token s is sequence s's only query
    k_pages: torch.Tensor,  # [P, page_size, 1, Dc]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, MAXP]
    *,
    sm_scale: float,
    v_dim: int,
    k_scale: Optional[float] = None,
    drop: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:  # [T, H, v_dim]
    """K9's split-and-merge in plain PyTorch: each slot's latent range is cut
    into the pieces mla_split_plan() gives on an H100, each piece gives
    (o, m, l) in f32 (an empty piece gives m = -inf, l = 0), and the pieces
    merge in split order. Rows past S and slots with kv_len 0 are zeros.
    drop = (slot, piece) leaves that piece out of the merge: a planted
    fault, the output of a merge that lost a piece."""
    T, H, Dc = q.shape
    S, maxp = page_indices.shape
    capacity = maxp * k_pages.shape[1]
    splits, split_len = mla_split_plan(capacity, S, -(-H // HEAD_GROUP))
    out = torch.zeros(T, H, v_dim, dtype=torch.float32, device=q.device)
    for s in range(min(S, T)):
        hi = min(int(kv_lens[s]), capacity)
        k = _widen(k_pages[page_indices[s].long()].reshape(capacity, Dc), k_scale, q.dtype).float()
        qs = q[s].float()
        o_run = torch.zeros(H, v_dim, dtype=torch.float32, device=q.device)
        m_run = torch.full((H,), float("-inf"), device=q.device)
        l_run = torch.zeros(H, device=q.device)
        for sp in range(splits):
            a, b = sp * split_len, min(hi, (sp + 1) * split_len)
            if b <= a or drop == (s, sp):
                continue  # an empty piece: l = 0 leaves the merge as it is
            sc = (qs @ k[a:b].T) * sm_scale  # [H, rows]
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            l = p.sum(-1)
            o = p @ k[a:b, :v_dim]
            m_new = torch.maximum(m_run, m)
            alpha, w = torch.exp(m_run - m_new), torch.exp(m - m_new)
            o_run = o_run * alpha[:, None] + o * w[:, None]
            l_run = l_run * alpha + l * w
            m_run = m_new
        inv = torch.where(l_run > 0, 1.0 / l_run.clamp_min(1e-30), torch.zeros_like(l_run))
        out[s] = o_run * inv[:, None]
    return out.to(q.dtype)


# ---------------------------------------------------------------- CUDA wrappers

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Parameters of the C entry points of csrc/mla_attention.cu, in order.
# decode: q, k_pages, kv_lens, page_indices, out, scratch; num_rows,
# num_seqs (S), maxp, page_size, n_heads, latent_dim, v_dim, splits,
# split_len; sm_scale; latent_int8, k_scale; stream.
_DECODE_ARGTYPES = [_P] * 6 + [_I] * 9 + [_F, _I, _F, _P]
# prefill: q, k_pages, kv_lens, page_indices, cu_q_lens, num_seqs, out,
# scratch; num_tokens, S, maxp, page_size, n_heads, latent_dim, v_dim,
# splits, split_len; sm_scale; latent_int8, k_scale; stream.
_PREFILL_ARGTYPES = [_P] * 8 + [_I] * 9 + [_F, _I, _F, _P]
ENTRY_POINTS = {
    "scalellm_mla_decode": _DECODE_ARGTYPES,
    "scalellm_mla_prefill": _PREFILL_ARGTYPES,
}


def _library() -> ctypes.CDLL:
    lib = _build.load("mla_attention")
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check_cuda_operands(q, k_pages, v_dim, k_scale, **index_tensors):
    """Raise on what the kernels do not take; returns (T, H, Dc, S, maxp,
    page, the entry points' latent_int8 and k_scale)."""
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    if k_pages.dim() != 4 or k_pages.shape[2] != 1:
        raise ValueError(f"k_pages must be [P, page, 1, Dc], got {tuple(k_pages.shape)}")
    if q.dtype != torch.bfloat16 or k_pages.dtype not in (torch.bfloat16, torch.int8):
        raise NotImplementedError(f"the MLA kernels take bf16 q and bf16 or int8 pages, got {q.dtype}, "
                                  f"{k_pages.dtype}")
    int8 = k_pages.dtype == torch.int8
    if not int8 and k_scale is not None:
        raise NotImplementedError("k_scale scales int8 latent pages; the kernels read bf16 pages as they are")
    T, H, Dc = q.shape
    if k_pages.shape[3] != Dc:
        raise ValueError(f"q {tuple(q.shape)} does not match k_pages {tuple(k_pages.shape)}")
    if (Dc, v_dim) != (KERNEL_LATENT_DIM, KERNEL_V_DIM):
        raise NotImplementedError(
            f"the MLA kernels take Dc={KERNEL_LATENT_DIM}, v_dim={KERNEL_V_DIM}; got Dc={Dc}, v_dim={v_dim}")
    for name, t in (("q", q), ("k_pages", k_pages), *index_tensors.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name not in ("q", "k_pages") and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16:
        raise ValueError("q and k_pages must be 16-byte aligned (the kernels copy 16 bytes at a time)")
    S, maxp = index_tensors["page_indices"].shape
    if index_tensors["kv_lens"].shape != (S,):
        raise ValueError("kv_lens must be [S]")
    return T, H, Dc, S, maxp, k_pages.shape[1], int(int8), 1.0 if k_scale is None else float(k_scale)


def _split_scratch(q, S, kv_capacity, H, v_dim):
    """The split plan and its f32 partials: o [S, splits, H, v_dim], then
    (m, l) [S, splits, H], allocated on the current stream."""
    splits, split_len = mla_split_plan(kv_capacity, S, -(-H // HEAD_GROUP), _sm_count(q.device))
    scratch = torch.empty(S * splits * H * (v_dim + 2), dtype=torch.float32, device=q.device)
    return splits, split_len, scratch


def mla_decode_attention_cuda(q, k_pages, kv_lens, page_indices, *, sm_scale, v_dim,
                              k_scale: Optional[float] = None) -> torch.Tensor:
    """Launch K9 on the current stream: row s < S attends sequence s (one
    query token each), rows >= S come out zero. Returns bf16 [T, H, v_dim].
    int8 pages are read as bf16((int8 -> f32) * k_scale) (None reads 1.0).
    `mla_decode_attention_cuda.launches` counts the launches, `.int8` those
    on int8 pages."""
    T, H, Dc, S, maxp, page, int8, scale = _check_cuda_operands(
        q, k_pages, v_dim, k_scale, kv_lens=kv_lens, page_indices=page_indices)
    if T < S:
        raise ValueError(f"a decode-only batch has a row per sequence slot: T={T} < S={S}")
    out = torch.empty(T, H, v_dim, dtype=torch.bfloat16, device=q.device)
    splits, split_len, scratch = _split_scratch(q, S, maxp * page, H, v_dim)
    rc = _library().scalellm_mla_decode(
        q.data_ptr(), k_pages.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), T, S, maxp, page, H, Dc, v_dim, splits, split_len,
        float(sm_scale), int8, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mla decode kernel launch failed: CUDA error {rc}")
    mla_decode_attention_cuda.launches += 1
    mla_decode_attention_cuda.int8.launches += int8
    return out


mla_decode_attention_cuda.launches = 0
mla_decode_attention_cuda.int8 = LaunchCount("mla_decode_attention_int8")


def mla_prefill_attention_cuda(q, k_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
                               sm_scale, v_dim, k_scale: Optional[float] = None) -> torch.Tensor:
    """Launch K10 on the current stream over a ragged mixed batch: q tiles
    of TILE_TOKENS tokens for sequences of 2 or more tokens, split blocks
    for the others. Returns bf16 [T, H, v_dim]. int8 pages as in K9.
    `mla_prefill_attention_cuda.launches` counts the launches, `.int8` those
    on int8 pages."""
    T, H, Dc, S, maxp, page, int8, scale = _check_cuda_operands(
        q, k_pages, v_dim, k_scale, kv_lens=kv_lens, page_indices=page_indices, cu_q_lens=cu_q_lens,
        num_seqs=num_seqs)
    if cu_q_lens.shape != (S + 1,) or num_seqs.shape != (1,):
        raise ValueError("cu_q_lens and num_seqs must be [S+1] and [1]")
    out = torch.empty(T, H, v_dim, dtype=torch.bfloat16, device=q.device)
    splits, split_len, scratch = _split_scratch(q, S, maxp * page, H, v_dim)
    rc = _library().scalellm_mla_prefill(
        q.data_ptr(), k_pages.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
        cu_q_lens.data_ptr(), num_seqs.data_ptr(), out.data_ptr(), scratch.data_ptr(), T, S,
        maxp, page, H, Dc, v_dim, splits, split_len, float(sm_scale), int8, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mla prefill kernel launch failed: CUDA error {rc}")
    mla_prefill_attention_cuda.launches += 1
    mla_prefill_attention_cuda.int8.launches += int8
    return out


mla_prefill_attention_cuda.launches = 0
mla_prefill_attention_cuda.int8 = LaunchCount("mla_prefill_attention_int8")


def mla_paged_attention(
    q: torch.Tensor,  # [T, H, Dc]
    k_pages: torch.Tensor,  # [P, page_size, 1, Dc]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, MAXP]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_seqs: torch.Tensor,  # i32[1]
    *,
    sm_scale: float,
    v_dim: int,
    k_scale: Optional[float] = None,
    decode_only: bool = False,
) -> torch.Tensor:  # [T, H, v_dim]
    """K9 for a decode-only batch, K10 otherwise, on a CUDA tensor; the
    plain versions on a CPU tensor."""
    if q.device.type == "cpu":
        return plain_mla_paged_attention(q, k_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
                                         sm_scale=sm_scale, v_dim=v_dim, k_scale=k_scale,
                                         decode_only=decode_only)
    if decode_only:
        return mla_decode_attention_cuda(q, k_pages, kv_lens, page_indices, sm_scale=sm_scale,
                                         v_dim=v_dim, k_scale=k_scale)
    return mla_prefill_attention_cuda(q, k_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
                                      sm_scale=sm_scale, v_dim=v_dim, k_scale=k_scale)


def plain_mla_paged_attention(q, k_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
                              sm_scale, v_dim, k_scale=None, decode_only=False):
    """mla_paged_attention's plain versions on whatever device q lies: what
    the kernels are held against on the card."""
    if decode_only:
        return plain_mla_decode(q, k_pages, kv_lens, page_indices, sm_scale=sm_scale, v_dim=v_dim,
                                k_scale=k_scale)
    return plain_mla_prefill(q, k_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
                             sm_scale=sm_scale, v_dim=v_dim, k_scale=k_scale)
