"""scalellm_tpu_torch/ops/mla_attention.py against the JAX package's
ops/mla_attention.py on the CPU, from numpy-seeded inputs handed to both:
the latent scatter, the reference, and the plain versions of the two
kernels against the Pallas kernels run in interpret mode (the shapes of
tests/test_mla_attention.py; the Pallas kernels need v_dim % 128 == 0).

Tolerances: the reference and the scatter are the same f32 arithmetic:
1e-5. The Pallas kernels round q * sm_scale, the latent rows and p to bf16
before their dots (8-bit mantissa, relative 2^-9 each) while the plain
versions stay in f32; outputs are averages of rows of std 0.2, so their
difference stays below 3e-3 (measured 7e-4 at output magnitude 0.24)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.ops import mla_attention as J
from scalellm_tpu_torch.ops import mla_attention as M

EXACT = 1e-5
BF16_DOTS = 3e-3


def _setup(rng, S, H, Dc, ps, pps, kv_lens, T):
    """q [T, H, Dc], latent pages with sequence i on pages 1 + i * pps ...
    (page 0 is the padding page), kv_lens [S], the block table [S, pps]."""
    P = S * pps + 1
    q = (rng.standard_normal((T, H, Dc)) * 0.2).astype(np.float32)
    pages = np.zeros((P, ps, 1, Dc), np.float32)
    pi = np.zeros((S, pps), np.int32)
    for i in range(S):
        pi[i] = 1 + i * pps + np.arange(pps)
        pages[pi[i]] = (rng.standard_normal((pps, ps, 1, Dc)) * 0.2).astype(np.float32)
    return q, pages, np.asarray(kv_lens, np.int32), pi


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_set_latent_cache_matches_jax():
    rng = np.random.default_rng(0)
    pages = rng.standard_normal((6, 4, 1, 24)).astype(np.float32)
    rows = rng.standard_normal((5, 24)).astype(np.float32)
    slots = np.asarray([5, 0, 23, 9, 12], np.int32)  # slot 0: the padding page
    want = np.asarray(J.set_latent_cache(jnp.asarray(pages), jnp.asarray(rows), jnp.asarray(slots)))
    got = _t(pages.copy())
    out = M.set_latent_cache(got, _t(rows), _t(slots))
    assert out.data_ptr() == got.data_ptr()  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(NotImplementedError):
        M.set_latent_cache(torch.zeros(2, 4, 1, 24, dtype=torch.int8), _t(rows), _t(slots), scale=0.1)


def test_ref_matches_jax_on_a_mixed_batch():
    rng = np.random.default_rng(1)
    S, H, Dc, ps, pps, v_dim, T = 4, 4, 256, 4, 8, 128, 32
    kv_lens, cu = [20, 11, 7, 0], [0, 20, 23, 24, 24]  # prefill, chunk tail, decode, padding
    q, pages, kl, pi = _setup(rng, S, H, Dc, ps, pps, kv_lens, T)
    args = (q, pages, kl, pi, np.asarray(cu, np.int32), np.asarray([3], np.int32))
    want = np.asarray(J.ref_mla_paged_attention(*map(jnp.asarray, args), sm_scale=0.13, v_dim=v_dim))
    got = M.ref_mla_paged_attention(*map(_t, args), sm_scale=0.13, v_dim=v_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=EXACT, atol=EXACT)


def test_plain_decode_matches_the_pallas_kernel():
    rng = np.random.default_rng(0)
    v_dim = 128
    S, H, Dc, ps, pps, T = 3, 8, 384, 4, 8, 8  # rows 3..7: bucket padding
    q, pages, kl, pi = _setup(rng, S, H, Dc, ps, pps, [30, 7, 0], T)  # seq 2: kv_len 0
    want = np.asarray(J.mla_decode_attention(
        jnp.asarray(q[:S]), jnp.asarray(pages), jnp.asarray(kl), jnp.asarray(pi),
        sm_scale=0.11, v_dim=v_dim, interpret=True))
    got = M.plain_mla_decode(_t(q), _t(pages), _t(kl), _t(pi), sm_scale=0.11, v_dim=v_dim)
    assert got.shape == (T, H, v_dim)
    np.testing.assert_allclose(got[:S].numpy(), want, rtol=0, atol=BF16_DOTS)
    assert torch.all(got[2:] == 0)


def test_plain_prefill_matches_the_pallas_kernel():
    rng = np.random.default_rng(5)
    S, H, Dc, ps, pps, v_dim, T = 3, 4, 256, 4, 8, 128, 32
    kv_lens, cu = [20, 11, 0], [0, 20, 23, 23]  # full prefill, chunked tail, padding slot
    q, pages, kl, pi = _setup(rng, S, H, Dc, ps, pps, kv_lens, T)
    cu = np.asarray(cu, np.int32)
    want = np.asarray(J.mla_prefill_attention(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(kl), jnp.asarray(pi), jnp.asarray(cu),
        sm_scale=0.13, v_dim=v_dim, block_q=8, interpret=True))
    ref = np.asarray(J.ref_mla_paged_attention(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(kl), jnp.asarray(pi), jnp.asarray(cu),
        jnp.asarray([2], jnp.int32), sm_scale=0.13, v_dim=v_dim))
    got = M.plain_mla_prefill(_t(q), _t(pages), _t(kl), _t(pi), _t(cu), _t(np.asarray([2], np.int32)),
                              sm_scale=0.13, v_dim=v_dim)
    np.testing.assert_allclose(got[:23].numpy(), want[:23], rtol=0, atol=BF16_DOTS)
    np.testing.assert_allclose(got[:23].numpy(), ref[:23], rtol=EXACT, atol=EXACT)
    assert torch.all(got[23:] == 0)  # rows past cu_q_lens[num_seqs]


def test_dispatcher_sends_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(3)
    S, H, Dc, ps, pps, v_dim, T = 2, 4, 192, 4, 4, 128, 16
    q, pages, kl, pi = _setup(rng, S, H, Dc, ps, pps, [9, 3], T)
    cu = np.asarray([0, 1, 2], np.int32)  # a decode-only batch: token s of sequence s
    args = [_t(x) for x in (q, pages, kl, pi, cu, np.asarray([2], np.int32))]
    kw = dict(sm_scale=0.2, v_dim=v_dim)
    dec = M.mla_paged_attention(*args, decode_only=True, **kw)
    mixed = M.mla_paged_attention(*args, **kw)
    torch.testing.assert_close(dec, M.plain_mla_decode(*args[:4], **kw), rtol=0, atol=0)
    torch.testing.assert_close(mixed, M.plain_mla_prefill(*args, **kw), rtol=0, atol=0)
    # The same batch either way: the decode rows agree, the padding is zero.
    torch.testing.assert_close(dec, mixed, rtol=EXACT, atol=EXACT)
    with pytest.raises(NotImplementedError):
        M.mla_paged_attention(*args, k_scale=0.5, **kw)
    with pytest.raises(ValueError):  # the CUDA wrappers refuse CPU tensors
        M.mla_decode_attention_cuda(*args[:4], **kw)
