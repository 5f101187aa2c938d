"""KV-cache scatter (counterpart of scalellm_tpu/ops/kv_update.py:set_kv_cache).

Writes the new tokens' K/V into the combined paged cache
[num_pages, page_size, 2 * n_kv_heads, head_dim], K at even and V at odd
combined heads. Global slot s lives at page s // page_size, row
s % page_size. Padding tokens write to slots of page 0, the reserved
padding page, so those writes are harmless.

The write is IN PLACE (index_copy_ on the flattened pages): the cache is one
persistent tensor that every step updates, as the reference's donated cache
buffer is updated in place by XLA.
"""

from __future__ import annotations

import torch


def set_kv_cache(
    kv_pages: torch.Tensor,  # [P, page_size, 2*n_kv_heads, head_dim]
    k: torch.Tensor,  # [T, n_kv_heads, head_dim]
    v: torch.Tensor,  # [T, n_kv_heads, head_dim]
    slot_ids: torch.Tensor,  # [T] global slot ids
    k_scale=None,
    v_scale=None,
) -> torch.Tensor:
    """Scatter k/v into kv_pages in place; returns kv_pages."""
    num_pages, page_size, h2, head_dim = kv_pages.shape
    T, n_kv, _ = k.shape
    if kv_pages.dtype == torch.int8:
        # Quantized cache: store round(x / scale) clamped to int8.
        k = torch.round(k.float() / k_scale).clamp(-127, 127)
        v = torch.round(v.float() / v_scale).clamp(-127, 127)
    # Interleave: combined[t, 2h] = k[t, h]; combined[t, 2h+1] = v[t, h].
    combined = torch.stack([k, v], dim=2).reshape(T, 2 * n_kv, head_dim)
    flat = kv_pages.view(num_pages * page_size, h2, head_dim)
    flat.index_copy_(0, slot_ids.long(), combined.to(kv_pages.dtype))
    return kv_pages
