"""Plain PyTorch ragged paged attention.

A transcription of scalellm_tpu/ops/attention_ref.py:ref_ragged_paged_attention,
the contract of the CUDA kernel in csrc/ragged_paged_attention.cu. The tests
hold it to the JAX function; on the card it is the yardstick the kernel is
checked against, and on the CPU it is the attention the model runs.

One call handles a ragged batch that mixes prefill chunks and decode tokens:
q is flattened to [T, H, D] and each sequence's chunk is the tail of its KV
context (cu_q_lens gives the chunk boundaries, kv_lens the context lengths).
KV pages are [P, page_size, 2 * Hkv, D] with K at even and V at odd combined
heads, reached through a block table. GQA, causal masking by absolute
position, a sliding window (<= 0 disables it), a logit soft cap, static
int8 k/v scales and ALiBi slopes are covered.

Rows that own no KV are fully masked and come out as zeros, not NaN: rows of
zero-length padding sequences, and rows at or past cu_q_lens[num_seqs] (the
bucket padding after the last real token).

Inefficient by design: it gathers a [T, MAXP * page_size, Hkv, D] tensor.
"""

from __future__ import annotations

from typing import Optional

import torch


def ref_ragged_paged_attention(
    q: torch.Tensor,  # [T, n_heads, head_dim]
    kv_pages: torch.Tensor,  # [P, page_size, 2*n_kv_heads, head_dim]
    kv_lens: torch.Tensor,  # i32[S]
    page_indices: torch.Tensor,  # i32[S, MAXP]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_seqs: torch.Tensor,  # i32[1]
    *,
    sm_scale: float = 1.0,
    sliding_window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    k_scale: Optional[float] = None,
    v_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # f32[n_heads]
) -> torch.Tensor:
    T, n_heads, head_dim = q.shape
    S, MAXP = page_indices.shape
    page_size = kv_pages.shape[1]
    n_kv_heads = kv_pages.shape[2] // 2
    group = n_heads // n_kv_heads
    KV = MAXP * page_size
    dev = q.device

    # Owning sequence of each flattened q token, and its absolute position.
    tok = torch.arange(T, dtype=torch.int32, device=dev)
    token_seg = torch.searchsorted(
        cu_q_lens[1:].contiguous(), tok, right=True
    ).clamp(0, S - 1)
    q_lens = cu_q_lens[1:] - cu_q_lens[:-1]
    positions = kv_lens[token_seg] - q_lens[token_seg] + (tok - cu_q_lens[token_seg])

    # Gather each sequence's KV pages: [S, KV, n_kv_heads, head_dim].
    pages = kv_pages[page_indices.long()]  # [S, MAXP, page, 2H, D]
    k_seq = pages[:, :, :, 0::2, :].reshape(S, KV, n_kv_heads, head_dim)
    v_seq = pages[:, :, :, 1::2, :].reshape(S, KV, n_kv_heads, head_dim)
    kf = k_seq[token_seg].float()  # [T, KV, H_kv, D]
    vf = v_seq[token_seg].float()
    if k_scale is not None:
        kf = kf * k_scale
    if v_scale is not None:
        vf = vf * v_scale

    qf = q.reshape(T, n_kv_heads, group, head_dim).float()
    scores = torch.einsum("thgd,tjhd->thgj", qf, kf) * sm_scale
    kv_idx = torch.arange(KV, dtype=torch.int32, device=dev)[None, :]  # [1, KV]
    pos = positions[:, None]  # [T, 1]
    if alibi_slopes is not None:
        # score += slope_h * (j - i), applied after sm_scale.
        dist = (kv_idx - pos).float()
        sl = alibi_slopes.float().reshape(1, n_kv_heads, group, 1)
        scores = scores + sl * dist[:, None, None, :]
    if logit_soft_cap is not None and logit_soft_cap > 0.0:
        scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)

    valid = kv_idx < kv_lens[token_seg][:, None]
    causal = kv_idx <= pos
    real = (tok < cu_q_lens[num_seqs.long()])[:, None]
    mask = valid & causal & real
    if sliding_window is not None and sliding_window > 0:
        mask = mask & (kv_idx > pos - sliding_window)
    mask = mask[:, None, None, :]  # [T, 1, 1, KV]

    scores = scores.masked_fill(~mask, float("-inf"))
    # NaN-safe softmax: fully-masked rows produce zeros.
    smax = scores.amax(dim=-1, keepdim=True)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    unnorm = torch.exp(scores - smax).masked_fill(~mask, 0.0)
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / denom.clamp_min(1e-30)

    out = torch.einsum("thgj,tjhd->thgd", probs, vf)
    return out.reshape(T, n_heads, head_dim).to(q.dtype)
