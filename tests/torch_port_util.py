"""Shared helpers of the tests that hold the PyTorch port to the JAX package."""

import numpy as np


def ragged_batch(rng, *, q_lens, kv_lens, S, T, n_heads, n_kv_heads, head_dim,
                 page_size=4, num_pages=64, dtype=np.float32):
    """Random inputs of ragged paged attention, as numpy arrays.

    Real sequence i has a chunk of q_lens[i] query tokens at the tail of a
    context of kv_lens[i] tokens; sequence slots past len(q_lens) are
    padding (kv_len 0, cu_q_lens repeating its last value) and token rows
    past sum(q_lens) are bucket padding. Pages are distinct and never page 0
    (the reserved padding page)."""
    n_real = len(q_lens)
    maxp = max(-(-k // page_size) for k in kv_lens)
    q = rng.standard_normal((T, n_heads, head_dim)).astype(dtype)
    kv_pages = rng.standard_normal(
        (num_pages, page_size, 2 * n_kv_heads, head_dim)
    ).astype(dtype)
    perm = rng.permutation(np.arange(1, num_pages))
    page_indices = np.zeros((S, maxp), np.int32)
    used = 0
    for i, k in enumerate(kv_lens):
        n = -(-k // page_size)
        page_indices[i, :n] = perm[used : used + n]
        used += n
    kv = np.zeros(S, np.int32)
    kv[:n_real] = kv_lens
    cu = np.zeros(S + 1, np.int32)
    cu[1 : n_real + 1] = np.cumsum(q_lens)
    cu[n_real + 1 :] = cu[n_real]
    return dict(
        q=q, kv_pages=kv_pages, kv_lens=kv, page_indices=page_indices,
        cu_q_lens=cu, num_seqs=np.array([n_real], np.int32),
    )
