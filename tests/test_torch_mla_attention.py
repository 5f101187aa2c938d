"""scalellm_tpu_torch/ops/mla_attention.py against the JAX package's
ops/mla_attention.py on the CPU, from numpy-seeded inputs handed to both:
the latent scatter, the reference, and the plain versions of the two
kernels against the Pallas kernels run in interpret mode (the shapes of
tests/test_mla_attention.py; the Pallas kernels need v_dim % 128 == 0).
Then K9's split-and-merge in plain PyTorch (plain_mla_split_decode) under
mla_split_plan's pieces, the plan itself, and the row check that catches a
merge that lost a piece.

Tolerances: the reference and the scatter are the same f32 arithmetic:
1e-5. The Pallas kernels round q * sm_scale, the latent rows and p to bf16
before their dots (8-bit mantissa, relative 2^-9 each) while the plain
versions stay in f32; outputs are averages of rows of std 0.2, so their
difference stays below 3e-3 (measured 7e-4 at output magnitude 0.24).
The split-and-merge against the reference and the plain decode: both f32,
the merge only reorders the sums: 1e-5."""

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
    # int8 pages: round(x / scale) clamped to [-127, 127], in place, as the JAX function.
    pages8 = torch.zeros(6, 4, 1, 24, dtype=torch.int8)
    M.set_latent_cache(pages8, _t(rows), _t(slots), scale=0.1)
    want8 = J.set_latent_cache(jnp.zeros((6, 4, 1, 24), jnp.int8), jnp.asarray(rows), jnp.asarray(slots), scale=0.1)
    np.testing.assert_array_equal(pages8.numpy(), np.asarray(want8))


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


# ------------------------------------------------------------ split-KV decode (K9's pieces)

# Decode-only batches: (n_heads, Dc, page, pages a slot, kv_lens, S, T). The
# block table holds 256 rows, so mla_split_plan cuts each slot into four
# pieces of 64: contexts of 0-129 rows leave pieces past kv_len, and rows
# past S are bucket padding.
SPLIT_DECODE_CASES = {
    "page4_past_kv_len": (8, 192, 4, 64, [250, 70, 0], 3, 8),
    "page16_two_head_groups": (20, 192, 16, 16, [256, 129, 3, 64], 4, 4),
    "page16_one_row_and_padding_rows": (16, 256, 16, 16, [1, 200], 2, 16),
}


@pytest.mark.parametrize("case", list(SPLIT_DECODE_CASES))
def test_plain_split_decode_matches_the_pallas_kernel_and_the_reference(case):
    H, Dc, ps, pps, kv_lens, S, T = SPLIT_DECODE_CASES[case]
    v_dim = 128
    rng = np.random.default_rng(sum(map(ord, case)))
    q, pages, kl, pi = _setup(rng, S, H, Dc, ps, pps, kv_lens, T)
    splits, split_len = M.mla_split_plan(pps * ps, S, -(-H // M.HEAD_GROUP))
    assert splits > 1 and split_len == M.MLA_STEP  # the merge adds several pieces
    got = M.plain_mla_split_decode(_t(q), _t(pages), _t(kl), _t(pi), sm_scale=0.11, v_dim=v_dim)
    assert got.shape == (T, H, v_dim)
    want = np.asarray(J.mla_decode_attention(
        jnp.asarray(q[:S]), jnp.asarray(pages), jnp.asarray(kl), jnp.asarray(pi),
        sm_scale=0.11, v_dim=v_dim, interpret=True))
    np.testing.assert_allclose(got[:S].numpy(), want, rtol=0, atol=BF16_DOTS)
    cu = np.arange(S + 1, dtype=np.int32)  # token s is slot s's query
    ref = np.asarray(J.ref_mla_paged_attention(
        jnp.asarray(q[:S]), jnp.asarray(pages), jnp.asarray(kl), jnp.asarray(pi), jnp.asarray(cu),
        jnp.asarray([S], jnp.int32), sm_scale=0.11, v_dim=v_dim))
    live = np.asarray(kv_lens) > 0  # the reference gives a slot with no rows a uniform average
    np.testing.assert_allclose(got[:S].numpy()[live], ref[live], rtol=EXACT, atol=EXACT)
    assert torch.all(got[S:] == 0) and torch.all(got[:S][torch.from_numpy(~live)] == 0)
    # The plain decode's single softmax and the merge of the pieces agree.
    plain = M.plain_mla_decode(_t(q), _t(pages), _t(kl), _t(pi), sm_scale=0.11, v_dim=v_dim)
    torch.testing.assert_close(got, plain, rtol=EXACT, atol=EXACT)


def test_mla_split_plan_from_integers():
    n_sm = 132
    # Enough (slot, head group) pairs to fill the card: split only to the cap.
    assert M.mla_split_plan(4096, 64, 1, n_sm) == (16, 256)
    assert M.mla_split_plan(1024, 2 * n_sm, 1, n_sm) == (4, 256)
    # The engine's 8-decode step at V2-Lite: one piece a 64-row step.
    assert M.mla_split_plan(1024, 8, 1, n_sm) == (16, 64)
    # A table shorter than a step: one piece of one step.
    assert M.mla_split_plan(16, 1, 1, n_sm) == (1, M.MLA_STEP)
    assert M.mla_split_plan(0, 1, 8, n_sm) == (1, M.MLA_STEP)
    # One long slot: never more pieces than steps.
    assert M.mla_split_plan(16384, 1, 1, n_sm) == (256, 64)
    assert M.mla_split_plan(256, 1, 1, n_sm) == (4, 64)
    for capacity in (1, 63, 64, 65, 600, 1024, 8192, 65536):
        for slots, groups in ((1, 1), (1, 8), (8, 1), (8, 8), (64, 1), (256, 8)):
            splits, split_len = M.mla_split_plan(capacity, slots, groups, n_sm)
            assert type(splits) is int and type(split_len) is int
            assert split_len % M.MLA_STEP == 0 and M.MLA_STEP <= split_len <= max(M.MLA_MAX_SPLIT_LEN, M.MLA_STEP)
            assert splits * split_len >= capacity  # the pieces cover the table
            assert (splits - 1) * split_len < max(capacity, 1)  # and no piece lies wholly past it


def test_cuda_wrappers_plan_from_shapes_alone():
    """The launch plan comes from shapes: the wrappers and the plan read no
    device value (no host sync), so a captured graph can replay them."""
    import inspect

    for fn in (M.mla_split_plan, M._split_scratch, M._check_cuda_operands, M.mla_decode_attention_cuda,
               M.mla_prefill_attention_cuda):
        src = inspect.getsource(fn)
        for sync in (".item(", ".tolist(", ".cpu(", ".max(", "int(kv_lens", "int(num_seqs", "numpy("):
            assert sync not in src, (fn.__name__, sync)


def test_ctypes_signatures_match_the_cuda_source():
    """The wrappers' ctypes argtypes follow the C entry points' parameter
    lists in csrc/mla_attention.cu."""
    import ctypes
    import pathlib
    import re

    src = (pathlib.Path(M.__file__).parent.parent / "csrc" / "mla_attention.cu").read_text()
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    for name, argtypes in M.ENTRY_POINTS.items():
        params = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S).group(1)
        want = []
        for p in params.split(","):
            words = p.replace("*", " * ").split()[:-1]  # drop the parameter name
            want.append(kinds["void*" if "*" in words else words[-1]])
        assert argtypes == want, name


# Decode batches at V2-Lite's widths in bf16, as on the card: (n_heads,
# page, kv_lens, S, the lost piece passes the absolute check). Scale
# Dc^-0.5: unit-variance scores, so a long context's rows are small.
LOST_PIECE_CASES = {
    "v2_lite_8192": (16, 16, [8192], 1, True),  # 128 pieces of 64
    "v2_lite_page4": (16, 4, [4096, 3000, 100], 3, False),
    "h128_two_slots": (128, 16, [2048, 700], 2, False),  # 8 head groups: 16 pieces of 128
}


@pytest.mark.parametrize("case", list(LOST_PIECE_CASES))
def test_row_check_fails_a_merge_that_lost_a_piece(case):
    """chip_smoke.py's row check (each (token, head) row's error within
    ATTENTION_REL_TOL of the row's size) passes the plain split-and-merge
    and fails it with the longest slot's middle piece left out: what K9
    would give had its merge lost that piece. At 8192 rows KERNEL_TOL
    alone passes that lost piece."""
    from chip_smoke import ATTENTION_REL_TOL, KERNEL_TOL, attention_row_rel_err
    from torch_port_util import latent_batch

    H, page, kv_lens, S, abs_passes = LOST_PIECE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    b = latent_batch(rng, q_lens=[1] * len(kv_lens), kv_lens=kv_lens, S=S, T=len(kv_lens), n_heads=H,
                     latent_dim=576, page_size=page)
    args = (_t(b["q"]).bfloat16(), _t(b["k_pages"]).bfloat16(), _t(b["kv_lens"]), _t(b["page_indices"]))
    kw = dict(sm_scale=576 ** -0.5, v_dim=512)
    want = M.plain_mla_decode(*args, **kw)
    good = M.plain_mla_split_decode(*args, **kw)
    assert (good.float() - want.float()).abs().max() <= KERNEL_TOL
    assert attention_row_rel_err(torch, good, want) <= ATTENTION_REL_TOL
    capacity = b["page_indices"].shape[1] * page
    _, split_len = M.mla_split_plan(capacity, S, -(-H // M.HEAD_GROUP))
    s = max(range(len(kv_lens)), key=lambda i: kv_lens[i])
    lost = M.plain_mla_split_decode(*args, **kw, drop=(s, (kv_lens[s] - 1) // split_len // 2))
    assert attention_row_rel_err(torch, lost, want) > ATTENTION_REL_TOL
    if abs_passes:
        assert (lost.float() - want.float()).abs().max() <= KERNEL_TOL
