"""The CUDA kernels against their plain versions, in bf16 on the card. Each
test skips when no CUDA device is present: the kernels have no CPU or
interpret mode. Run them on the card with
`python -m pytest --noconftest tests/test_torch_kernels.py -q`.

Ragged paged attention: tolerance 2e-2 absolute: both sum in f32, the kernel
with an online softmax; the outputs are rounded to bf16 (8 bits of mantissa)
from values of magnitude <= ~3. And row by row (token, head): the largest
error within 2e-2 of the row's largest magnitude (chip_smoke.py's
ATTENTION_REL_TOL; a bf16 step is at most 0.8% of it), which a merge that
lost one piece of a long context fails.

Quantized matmuls (w4a8, group, dequant): the integer dots are exact on
both sides; the f32 sums over groups and k-blocks run in another order, the
prologue's rsqrt may differ in its last bit (a rare +-1 in a quantized
activation), and the output is rounded to bf16. Tolerance: 1% of the
output's largest magnitude (two to three bf16 steps there), and a mean
error below 0.1% of it.

CUDA graphs: each main-path wrapper captured in a graph and replayed on new
inputs gives the bits of an eager call; the executor with step graphs gives
the eager tokens and logits bits (tiny random-weight Llama, DeepSeek-V2,
Mixtral and Qwen2-MoE, bf16 and INT4). Multi-step decode: the N-step
graph's replay gives the eager N-step loop's bits (tokens, logprobs, KV cache), greedy and sampling; the
device sampler draws the same noise eagerly and in a replay; a fetch
returns while a later step runs; async and N = 4 serves with graphs give
the sync serve's tokens. Mixtral and Qwen2-MoE: kernels against every
plain version with the routing pinned. Gemma2 and Qwen3: kernels against
the plain versions, bf16 and INT4, and their graphs and N-step replays
against eager. K1 at head dim 256, GQA groups 1-16, on pages that hold NaN
past every range. A closed engine gives its memory back to the card."""

import numpy as np
import pytest
import torch

# Imported by its own name (pytest puts tests/ on sys.path), so that an
# installed top-level package named `tests` cannot shadow this directory.
from torch_port_util import ragged_batch

from chip_smoke import ATTENTION_REL_TOL, attention_row_rel_err, dropped_piece
from scalellm_tpu_torch.ops import attention

TOL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on(inputs, device):
    out = {}
    for k, v in inputs.items():
        t = torch.from_numpy(v).to(device)
        out[k] = t.to(torch.bfloat16) if t.is_floating_point() else t
    return out


# (q_lens, kv_lens, S, T, n_heads, n_kv_heads, head_dim, window, soft_cap, page)
SHAPES = {
    "decode_gqa8_d64": ([1] * 8, [17, 40, 64, 100, 250, 513, 800, 1024], 8, 16, 32, 4, 64, None, None, 16),
    "mixed_padded": ([37, 64, 1, 1, 1, 1, 1, 1], [37, 200, 17, 90, 301, 5, 77, 1000], 16, 256, 32, 4, 64, None, None, 16),
    "gqa4_d128": ([5, 1, 1], [60, 33, 129], 4, 16, 32, 8, 128, None, None, 16),
    "window_softcap": ([9, 1, 1], [40, 70, 3], 4, 16, 8, 2, 64, 16, 30.0, 4),
    "no_padding_seq": ([3, 1], [3, 6], 2, 8, 8, 1, 64, None, None, 4),
}


def _assert_matches_plain(got, want, n_real):
    """Within TOL of the plain version, and row by row within
    ATTENTION_REL_TOL of the row's size (a lost KV piece moves a long
    context's small rows by less than TOL); padding rows zero."""
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert attention_row_rel_err(torch, got, want) <= ATTENTION_REL_TOL
    assert torch.all(got[n_real:] == 0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_plain_version(cuda, shape):
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention_cuda as kernel
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    q_lens, kv_lens, S, T, H, Hkv, D, window, cap, page = SHAPES[shape]
    rng = np.random.default_rng(0)
    inputs = _on(ragged_batch(
        rng, q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=H,
        n_kv_heads=Hkv, head_dim=D, page_size=page,
        num_pages=1 + sum(-(-k // page) for k in kv_lens),
    ), cuda)
    kw = dict(sm_scale=D ** -0.5, sliding_window=window, logit_soft_cap=cap)
    before = kernel.launches
    got = ragged_paged_attention(**inputs, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ref_ragged_paged_attention(**inputs, **kw)
    _assert_matches_plain(got, want, sum(q_lens))


def _attention_case(device, q_lens, kv_lens, S, T, H, Hkv, D, page, seed=0):
    rng = np.random.default_rng(seed)
    return _on(ragged_batch(
        rng, q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=H, n_kv_heads=Hkv,
        head_dim=D, page_size=page, num_pages=1 + sum(-(-k // page) for k in kv_lens),
    ), device)


def _check_attention(inputs, kw, n_real):
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention_cuda as kernel
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    before = kernel.launches
    got = kernel(**inputs, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ref_ragged_paged_attention(**inputs, **kw)
    _assert_matches_plain(got, want, n_real)
    return got, want


# Decode batches that split: (kv_lens, S, T, n_heads, n_kv_heads, head_dim,
# window, soft_cap, page).
SPLIT_CASES = {
    "long_d128_gqa4": ([8192, 2048, 5000], 4, 16, 32, 8, 128, None, None, 16),
    "long_d64_gqa8_page4": ([4096, 3000, 100], 4, 16, 32, 4, 64, None, None, 4),
    "window_mid_split": ([6000, 2048, 77], 4, 4, 32, 8, 128, 700, None, 16),
    "past_kv_len": ([2048, 70, 1, 300], 4, 16, 32, 8, 128, None, None, 16),
    "group16_softcap": ([3000, 2500], 2, 16, 32, 2, 128, None, 30.0, 16),
    "mha_d64_window_softcap_page4": ([2100, 640], 2, 2, 8, 8, 64, 333, 20.0, 4),
    # Qwen1.5-MoE-A2.7B's heads: 16 over 16 KV heads (group 1), head dim 128.
    "qwen2_moe_mha_d128": ([4096, 600, 17, 1024], 4, 16, 16, 16, 128, None, None, 16),
}


def _split_case(device, case):
    from scalellm_tpu_torch.ops.attention import split_kv_plan

    kv_lens, S, T, H, Hkv, D, window, cap, page = SPLIT_CASES[case]
    inputs = _attention_case(device, [1] * len(kv_lens), kv_lens, S, T, H, Hkv, D, page)
    maxp = inputs["page_indices"].shape[1]
    assert split_kv_plan(maxp * page, S, Hkv, torch.cuda.get_device_properties(device).multi_processor_count)[0] > 1
    return inputs, dict(sm_scale=D ** -0.5, sliding_window=window, logit_soft_cap=cap)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_cases_match_plain_version(cuda, case):
    inputs, kw = _split_case(cuda, case)
    _check_attention(inputs, kw, len(SPLIT_CASES[case][0]))


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_row_check_fails_a_merge_that_lost_a_piece(cuda, case):
    """The check above passes the kernel and fails the plain split-and-merge
    with the longest slot's middle piece left out: what the kernel would
    give had its merge lost that piece."""
    from scalellm_tpu_torch.ops.attention import plain_split_kv_attention

    inputs, kw = _split_case(cuda, case)
    kv_lens, S, _, _, Hkv, _, window, _, _ = SPLIT_CASES[case]
    got, want = _check_attention(inputs, kw, len(kv_lens))
    spec = dict(kv_lens=kv_lens, S=S, Hkv=Hkv, window=window)
    lost = plain_split_kv_attention(**inputs, **kw, drop=dropped_piece(attention, spec, inputs))
    assert attention_row_rel_err(torch, lost, want) > ATTENTION_REL_TOL
    assert attention_row_rel_err(torch, got, lost) > ATTENTION_REL_TOL


# Mixed batches whose chunks are no multiple of the tile's tokens (64 /
# group): (q_lens, kv_lens, S, T, n_heads, n_kv_heads, head_dim, window,
# soft_cap, page).
MIXED_CASES = {
    "chunks_d128_gqa4": ([37, 16, 17, 1, 1, 3], [37, 300, 1000, 2048, 5, 3], 8, 128, 32, 8, 128, None, None, 16),
    "chunks_d64_gqa8_window_page4": ([9, 23, 1, 2], [100, 23, 700, 2], 4, 64, 32, 4, 64, 50, 20.0, 4),
    "group16_d64": ([33, 1], [40, 600], 2, 64, 32, 2, 64, None, None, 16),
    "group6_d128": ([25, 7, 1], [25, 107, 333], 4, 64, 24, 4, 128, None, None, 16),
    "mha_d128": ([130, 1], [200, 90], 2, 256, 4, 4, 128, None, None, 16),
    "qwen2_moe_mha_d128": ([250, 200, 1, 1], [250, 300, 900, 17], 4, 512, 16, 16, 128, None, None, 16),
}


@pytest.mark.parametrize("case", list(MIXED_CASES))
def test_mixed_cases_match_plain_version(cuda, case):
    q_lens, kv_lens, S, T, H, Hkv, D, window, cap, page = MIXED_CASES[case]
    inputs = _attention_case(cuda, q_lens, kv_lens, S, T, H, Hkv, D, page)
    _check_attention(inputs, dict(sm_scale=D ** -0.5, sliding_window=window, logit_soft_cap=cap),
                     sum(q_lens))


@pytest.mark.parametrize("batch", ["decode", "mixed"])
def test_attention_is_bit_identical_across_calls(cuda, batch):
    """No float atomics: 20 calls give the same bits, on a decode batch
    (split blocks only) and a mixed one (tile and split blocks)."""
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention_cuda as kernel

    if batch == "decode":
        inputs = _attention_case(cuda, [1] * 4, [5000, 2048, 700, 1], 8, 16, 32, 8, 128, 16)
    else:
        inputs = _attention_case(cuda, [200, 1, 1, 77], [300, 4096, 900, 77], 8, 512, 32, 8, 128, 16)
    first = kernel(**inputs, sm_scale=128 ** -0.5)
    for _ in range(19):
        assert torch.equal(kernel(**inputs, sm_scale=128 ** -0.5), first)


# K1 at head dim 256 (Gemma, Gemma2): (q_lens, kv_lens, S, T, n_heads,
# n_kv_heads, window, soft_cap, page); GQA groups 1, 2, 8 and 16. The mixed
# batches stay small: the plain version gathers [T, context, Hkv, 256] f32.
D256_CASES = {
    "decode_group2_softcap": ([1] * 6, [17, 300, 1024, 2048, 4096, 5], 8, 16, 16, 8, None, 50.0, 16),
    "decode_group8_long": ([1] * 4, [8192, 100, 640, 33], 4, 16, 8, 1, None, None, 16),
    "decode_group16_window": ([1] * 3, [3000, 129, 4000], 4, 4, 16, 1, 128, None, 16),
    "mixed_group2_window_softcap": ([100, 120, 1, 1, 1], [100, 300, 900, 17, 1500], 8, 256, 16, 8, 128, 50.0, 16),
    "mixed_group1": ([37, 16, 1, 1], [37, 300, 700, 2048], 4, 64, 8, 8, None, None, 16),
    "mixed_group16_page4": ([33, 5, 1], [40, 600, 77], 4, 64, 16, 1, None, 30.0, 4),
}


def _nan_outside_ranges(inputs, q_lens, kv_lens, window):
    """The pages with NaN in every row that no token's KV range reaches: the
    rows of each sequence before its first token's window and past its
    context, and every page no sequence owns (page 0 included)."""
    kv = inputs["kv_pages"]
    page = kv.shape[1]
    out = torch.full_like(kv, float("nan"))
    for s, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        lo = max(0, kl - ql - window + 1) if window else 0
        pos = torch.arange(lo, kl, device=kv.device)
        pages = inputs["page_indices"][s].long()[pos // page]
        out[pages, pos % page] = kv[pages, pos % page]
    return out


@pytest.mark.parametrize("case", list(D256_CASES))
def test_head_dim_256_matches_plain_version(cuda, case):
    """Through the dispatcher (no fallback: one launch), on pages that hold
    NaN past every range: the rows of the padding tokens zero, each row
    within ATTENTION_REL_TOL of its size."""
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention_cuda as kernel
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    q_lens, kv_lens, S, T, H, Hkv, window, cap, page = D256_CASES[case]
    inputs = _attention_case(cuda, q_lens, kv_lens, S, T, H, Hkv, 256, page)
    kw = dict(sm_scale=256 ** -0.5, sliding_window=window, logit_soft_cap=cap)
    nan_pages = _nan_outside_ranges(inputs, q_lens, kv_lens, window)
    before = kernel.launches
    got = ragged_paged_attention(**{**inputs, "kv_pages": nan_pages}, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _assert_matches_plain(got, ref_ragged_paged_attention(**inputs, **kw), sum(q_lens))


def test_kernel_refuses_what_it_does_not_cover(cuda):
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention

    rng = np.random.default_rng(1)
    inputs = _on(ragged_batch(rng, q_lens=[1], kv_lens=[5], S=1, T=1, n_heads=4,
                              n_kv_heads=2, head_dim=64), cuda)
    with pytest.raises(NotImplementedError):
        ragged_paged_attention(**inputs, k_scale=0.5, v_scale=0.5)
    with pytest.raises(ValueError):  # slopes of another type or length
        ragged_paged_attention(**inputs, alibi_slopes=torch.ones(4, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ragged_paged_attention(**inputs, alibi_slopes=torch.ones(3, device=cuda))
    with pytest.raises(NotImplementedError):  # q and pages of two types
        ragged_paged_attention(**{**inputs, "q": inputs["q"].float()})
    with pytest.raises(NotImplementedError):
        ragged_paged_attention(**{**inputs, "q": inputs["q"].half(), "kv_pages": inputs["kv_pages"].half()})
    d96 = _on(ragged_batch(rng, q_lens=[1], kv_lens=[5], S=1, T=1, n_heads=4, n_kv_heads=2, head_dim=96), cuda)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        ragged_paged_attention(**d96)
    g32 = _on(ragged_batch(rng, q_lens=[1], kv_lens=[5], S=1, T=1, n_heads=32, n_kv_heads=1, head_dim=64), cuda)
    with pytest.raises(NotImplementedError, match="GQA group 32"):
        ragged_paged_attention(**g32)


# K1 with ALiBi (MPT, BLOOM), at head dim 80 (Phi-2) and in f32 (GPT-2):
# (q_lens, kv_lens, S, T, n_heads, n_kv_heads, head_dim, window, soft_cap,
# page). ALiBi over GQA groups 1, 4 and 16 at head counts that are no power
# of two (12, 20, 48: the slopes' interleaved tail); head dim 80 over groups
# 1, 2 and 8; f32 at head dims 64 and 128. Each through the dispatcher on
# pages that hold NaN past every range, against the plain version; f32
# within F32_TOL (f32 sums in another order, no TF32: a TF32 or bf16 score
# would be off by about 1e-3 of the output).
ALIBI_CASES = {
    "decode_group1_h12": ([1] * 6, [17, 300, 1024, 2048, 5, 900], 8, 16, 12, 12, 128, None, None, 16),
    "mixed_group1_h12_d64": ([100, 37, 1, 1], [100, 300, 700, 2048], 4, 256, 12, 12, 64, None, None, 16),
    "decode_group4_h20": ([1] * 4, [8192, 100, 640, 33], 4, 16, 20, 5, 64, None, None, 16),
    "mixed_group4_h20_window_softcap": ([60, 9, 1], [60, 200, 900], 4, 128, 20, 5, 128, 64, 30.0, 16),
    "decode_group16_h48": ([1] * 3, [3000, 129, 4000], 4, 4, 48, 3, 128, None, None, 16),
    "mixed_group16_h48_page4": ([33, 5, 1], [40, 600, 77], 4, 64, 48, 3, 64, None, None, 4),
}
D80_CASES = {
    "decode_group1_phi2": ([1] * 8, [17, 64, 129, 256, 400, 640, 900, 1024], 8, 16, 32, 32, 80, None, None, 16),
    "mixed_group1_phi2": ([120, 60, 1, 1], [120, 300, 500, 17], 4, 256, 32, 32, 80, None, None, 16),
    "decode_group2_window": ([1] * 4, [5000, 100, 640, 33], 4, 16, 16, 8, 80, 128, None, 16),
    "mixed_group8_softcap_page4": ([33, 5, 1], [40, 300, 77], 4, 64, 16, 2, 80, None, 30.0, 4),
}
F32_CASES = {
    "decode_d64_gpt2": ([1] * 8, [17, 64, 129, 256, 400, 640, 900, 1024], 8, 16, 12, 12, 64, None, None, 16),
    "mixed_d64_gpt2": ([100, 37, 1, 1], [100, 300, 700, 1024], 4, 256, 12, 12, 64, None, None, 16),
    "decode_d128_group4_window": ([1] * 4, [3000, 100, 640, 33], 4, 16, 16, 4, 128, 128, None, 16),
    "mixed_d128_group8_softcap_page4": ([33, 5, 1], [40, 300, 77], 4, 64, 16, 2, 128, None, 30.0, 4),
}
F32_TOL = 1e-4


def _k1_case(device, case, dtype=torch.bfloat16):
    q_lens, kv_lens, S, T, H, Hkv, D, window, cap, page = case
    rng = np.random.default_rng(0)
    raw = ragged_batch(rng, q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=H, n_kv_heads=Hkv,
                       head_dim=D, page_size=page, num_pages=1 + sum(-(-k // page) for k in kv_lens))
    inputs = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    inputs = {k: t.to(dtype) if t.is_floating_point() else t for k, t in inputs.items()}
    kw = dict(sm_scale=D ** -0.5, sliding_window=window, logit_soft_cap=cap)
    return inputs, kw, _nan_outside_ranges(inputs, q_lens, kv_lens, window), sum(q_lens)


def _through_dispatcher(inputs, nan_pages, kw, kind):
    """One launch of the dispatcher on the NaN pages, counted as `kind`."""
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention_cuda as kernel

    before = (kernel.launches, getattr(kernel, kind).launches)
    got = ragged_paged_attention(**{**inputs, "kv_pages": nan_pages}, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, getattr(kernel, kind).launches) == (before[0] + 1, before[1] + 1)
    return got


@pytest.mark.parametrize("case", list(ALIBI_CASES))
def test_alibi_matches_plain_version(cuda, case):
    from scalellm_tpu_torch.layers.alibi import alibi_slopes
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    inputs, kw, nan_pages, n_real = _k1_case(cuda, ALIBI_CASES[case])
    kw["alibi_slopes"] = torch.tensor(alibi_slopes(inputs["q"].shape[1]), dtype=torch.float32, device=cuda)
    got = _through_dispatcher(inputs, nan_pages, kw, "alibi")
    _assert_matches_plain(got, ref_ragged_paged_attention(**inputs, **kw), n_real)


@pytest.mark.parametrize("case", list(D80_CASES))
def test_head_dim_80_matches_plain_version(cuda, case):
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    inputs, kw, nan_pages, n_real = _k1_case(cuda, D80_CASES[case])
    got = _through_dispatcher(inputs, nan_pages, kw, "d80")
    _assert_matches_plain(got, ref_ragged_paged_attention(**inputs, **kw), n_real)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", list(F32_CASES))
def test_f32_kernel_matches_plain_version(cuda, case, alibi):
    from scalellm_tpu_torch.layers.alibi import alibi_slopes
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    inputs, kw, nan_pages, n_real = _k1_case(cuda, F32_CASES[case], torch.float32)
    if alibi:
        kw["alibi_slopes"] = torch.tensor(alibi_slopes(inputs["q"].shape[1]), dtype=torch.float32, device=cuda)
    got = _through_dispatcher(inputs, nan_pages, kw, "f32")
    want = ref_ragged_paged_attention(**inputs, **kw)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=0)
    assert torch.all(got[n_real:] == 0)
    # Same bits on every call: no atomics.
    for _ in range(3):
        assert torch.equal(_through_dispatcher(inputs, nan_pages, kw, "f32"), got)


# ---------------------------------------------------------------- quant matmul


def _quant_case(device, *, M, K, N, G, bits, asym, rms, scales_dtype, seed=0):
    """Random kernel-layout weights and a bf16 x of non-zero mean (an
    unsigned nibble unpack would shift the output by 8 * sum(x) * scale)."""
    rng = np.random.default_rng(seed)
    rows = K // 2 if bits == 4 else K
    qweight = torch.from_numpy(rng.integers(-128, 128, (N, rows), dtype=np.int8))
    scales = torch.from_numpy(rng.uniform(0.002, 0.02, (K // G, N)).astype(np.float32))
    lo, hi = (-8, 8) if bits == 4 else (-20, 20)
    zeros = torch.from_numpy(rng.integers(lo, hi, (K // G, N), dtype=np.int8)) if asym else None
    x = torch.from_numpy((rng.standard_normal((M, K)) + 0.5).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, K).astype(np.float32)) if rms else None
    on = lambda t, dt=None: None if t is None else t.to(device=device, dtype=dt or t.dtype)
    return dict(x=on(x, torch.bfloat16), qweight=on(qweight), scales=on(scales, scales_dtype),
                zeros=on(zeros), rms_gamma=on(gamma, torch.bfloat16 if rms == "bf16" else None))


def _check_quant(got, want):
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    assert diff.max().item() <= 1e-2 * top, (diff.max().item(), top)
    assert diff.mean().item() <= 1e-3 * top, (diff.mean().item(), top)


# (M, K, N, G, bits, asym, rms, scales dtype)
TILE_CASES = {
    "m8_g32_int4": (8, 256, 64, 32, 4, False, False, torch.float32),
    "m128_int4_asym": (128, 1024, 192, 128, 4, True, False, torch.float32),
    "m200_int4_rms": (200, 512, 128, 64, 4, True, True, torch.bfloat16),
    "m512_int4_8b": (512, 4096, 4096, 128, 4, False, False, torch.float32),
    "m70_int8_asym": (70, 512, 130, 128, 8, True, "bf16", torch.float32),
    "m256_int8": (256, 4096, 1024, 128, 8, False, False, torch.bfloat16),
    # The tile kernel's edges: each token tile (M 1 to 512), N not a multiple
    # of the weight tile, the DeepSeek-V2-Lite shared down at decode (K 2816,
    # G = 32, bf16 scales), K with a half stage at its end (K % 64 == 32),
    # int8 with zero points and bf16 scales, the prologue at one k-block,
    # and the 192-row tile (dequant, N = 6144).
    "m1_int4": (1, 1024, 256, 128, 4, False, False, torch.float32),
    "m16_shared_down_g32": (16, 2816, 2048, 32, 4, False, False, torch.bfloat16),
    "m65_int4_asym_ragged_n": (65, 1024, 2050, 128, 4, True, False, torch.bfloat16),
    "m129_int4_rms_g32_half_stage": (129, 2080, 384, 32, 4, True, True, torch.float32),
    "m257_int8_asym_bf16": (257, 1024, 1030, 64, 8, True, False, torch.bfloat16),
    "m512_int4_asym_rms": (512, 2048, 2560, 128, 4, True, "bf16", torch.float32),
    "m512_int4_n6144": (512, 1024, 6144, 128, 4, False, False, torch.float32),
    # Groups that are a multiple of 32 but not of 64: a stage's two 32-K
    # spans in two groups (G = 96, 160), one channel-wise group of K 2080.
    "m40_int4_asym_g96": (40, 576, 256, 96, 4, True, False, torch.float32),
    "m300_int8_g160": (300, 960, 320, 160, 8, False, False, torch.bfloat16),
    "m130_int4_asym_channelwise": (130, 2080, 192, 2080, 4, True, False, torch.float32),
}


@pytest.mark.parametrize("variant", ["group", "dequant"])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_kernels_match_plain_versions(cuda, case, variant):
    from scalellm_tpu_torch.ops import quant_matmul as Q

    M, K, N, G, bits, asym, rms, sdt = TILE_CASES[case]
    t = _quant_case(cuda, M=M, K=K, N=N, G=G, bits=bits, asym=asym, rms=rms, scales_dtype=sdt)
    kernel = getattr(Q, f"quant_matmul_{variant}_cuda")
    plain = getattr(Q, f"plain_{variant}")
    before = kernel.launches
    got = kernel(t["x"], t["qweight"], t["scales"], t["zeros"], bits, t["rms_gamma"], 1e-5)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(t["x"], t["qweight"], t["scales"], t["zeros"], bits, t["rms_gamma"], 1e-5)
    _check_quant(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("variant", ["group", "dequant"])
def test_tile_kernel_fragment_order(cuda, variant, bits):
    """One nonzero weight per column (3 at K = n % 32, scale 1, K = 32): the
    output is 3 x[:, n % 32] exactly, which holds only if every unpacked
    nibble (or byte) lands at its own K in the wgmma fragment."""
    from scalellm_tpu_torch.ops import quant_matmul as Q

    M, K, N = 24, 32, 64
    k_of = torch.arange(N) % K
    w = torch.zeros(N, K, dtype=torch.int32)
    w[torch.arange(N), k_of] = 3
    if bits == 4:
        qweight = ((w[:, 0::2] & 0xF) | ((w[:, 1::2] & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    else:
        qweight = w.to(torch.int8)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    kernel = getattr(Q, f"quant_matmul_{variant}_cuda")
    got = kernel(x.to(cuda), qweight.to(cuda), torch.ones(1, N, device=cuda), None, bits)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), (3 * x.float()[:, k_of]).to(torch.bfloat16))


def test_quant_dispatcher_goes_to_the_kernels(cuda):
    """quant_matmul on CUDA tensors launches the variant plan() names, and
    agrees with plain_quant_matmul, which makes the same decisions."""
    from scalellm_tpu_torch.ops import quant_matmul as Q

    t = _quant_case(cuda, M=16, K=1024, N=256, G=128, bits=4, asym=False, rms="bf16",
                    scales_dtype=torch.bfloat16)
    kw = dict(bits=4, symmetric=True, rms_gamma=t["rms_gamma"], rms_eps=1e-5)
    counts = lambda: (Q.quant_matmul_w4a8_cuda.launches, Q.quant_matmul_group_cuda.launches,
                      Q.quant_matmul_dequant_cuda.launches)
    c0 = counts()
    got = Q.quant_matmul(t["x"], t["qweight"], t["scales"], **kw)
    c1 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (1, 0, 0)
    _check_quant(got, Q.plain_quant_matmul(t["x"], t["qweight"], t["scales"], **kw))
    big = _quant_case(cuda, M=128, K=1024, N=256, G=128, bits=4, asym=False, rms=False,
                      scales_dtype=torch.bfloat16)
    got = Q.quant_matmul(big["x"], big["qweight"], big["scales"], bits=4, symmetric=True)
    c2 = counts()
    assert (c2[0] - c1[0], c2[1] - c1[1], c2[2] - c1[2]) == (0, 0, 1)
    _check_quant(got, Q.plain_quant_matmul(big["x"], big["qweight"], big["scales"], bits=4,
                                           symmetric=True))


def test_quant_kernels_refuse_what_they_do_not_cover(cuda):
    from scalellm_tpu_torch.ops import quant_matmul as Q

    t = _quant_case(cuda, M=8, K=256, N=64, G=128, bits=4, asym=False, rms=False,
                    scales_dtype=torch.float32)
    args = (t["qweight"], t["scales"], None, 4)
    with pytest.raises(NotImplementedError):
        Q.quant_matmul_w4a8_cuda(t["x"].float(), *args, 256)
    with pytest.raises(NotImplementedError):
        Q.quant_matmul_w4a8_cuda(t["x"].repeat(16, 1), *args, 256)  # M = 128
    g64 = _quant_case(cuda, M=8, K=256, N=64, G=64, bits=8, asym=False, rms=False,
                      scales_dtype=torch.float32)
    with pytest.raises(NotImplementedError):  # int8 at G = 64: a 128-K span lies inside one group
        Q.quant_matmul_w4a8_cuda(g64["x"], g64["qweight"], g64["scales"], None, 8, 256)
    with pytest.raises(ValueError):
        Q.quant_matmul_dequant_cuda(t["x"].cpu(), *args)
    with pytest.raises(ValueError):
        Q.quant_matmul(t["x"], *args[:2], variant="ref")


# ---------------------------------------------------------------- grouped GEMM (K6)
#
# Tolerance: the kernel and the plain version both sum exact bf16 products
# in f32, in another order: 1e-4 of the output's largest magnitude.


def _routed_rows(rng, T, E, k, K, n_pad=0):
    """Rows of T tokens routed to k of E experts by a seeded softmax, sorted
    by expert (some experts get no rows), and their group sizes. The last
    n_pad tokens share one input, as the engine's padding rows do."""
    def rows(shape):
        x = rng.standard_normal(shape)
        x[T - n_pad:] = x[T - 1]
        return x

    logits = rows((T, E))
    topk = np.argsort(-logits, axis=1)[:, :k].reshape(-1)
    order = np.argsort(topk, kind="stable")
    x = rows((T, K)).astype(np.float32)
    return x[order // k], np.bincount(topk, minlength=E).astype(np.int32)


# (tokens, padding tokens among them, experts, top-k, K, N, uncovered rows appended)
GMM_CASES = {
    "decode_r96_e64_padded": (16, 8, 64, 6, 256, 136, 0),
    "prefill_wide_tile": (512, 0, 8, 2, 128, 256, 0),
    "uncovered_rows": (20, 0, 16, 2, 96, 64, 5),
    # Mixtral-8x7B's gate/up (8 experts, top-2) and Qwen1.5-MoE-A2.7B's
    # (60 experts, top-4) at the decode step: 32 and 64 rows.
    "mixtral_decode_e8": (16, 8, 8, 2, 4096, 14336, 0),
    "qwen2_moe_decode_e60": (16, 8, 60, 4, 2048, 1408, 0),
}


@pytest.mark.parametrize("tile", [None, 0, 1])  # the wrapper's choice, then each block shape
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_grouped_matmul_kernel_matches_plain_version(cuda, case, tile):
    from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_cuda, plain_grouped_matmul

    T, n_pad, E, k, K, N, extra = GMM_CASES[case]
    rng = np.random.default_rng(0)
    xs, sizes = _routed_rows(rng, T, E, k, K, n_pad)
    xs = np.concatenate([xs, rng.standard_normal((extra, K)).astype(np.float32)])
    xs = torch.from_numpy(xs).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((E, N, K)).astype(np.float32) / np.sqrt(K)).to(cuda, torch.bfloat16)
    gs = torch.from_numpy(sizes).to(cuda)
    before = grouped_matmul_cuda.launches
    got = grouped_matmul(xs, w, gs) if tile is None else grouped_matmul_cuda(xs, w, gs, tile=tile)
    torch.cuda.synchronize()
    assert grouped_matmul_cuda.launches == before + 1
    want = plain_grouped_matmul(xs, w, gs)
    covered = int(sizes.sum())
    top = want.abs().max().item()
    assert torch.isfinite(got[:covered]).all()
    torch.testing.assert_close(got[:covered], want[:covered], atol=1e-4 * top, rtol=0)


def _gmm_into(out, xs, w, gs, tile):
    """The kernel's C entry point into a given output buffer (the wrapper
    allocates its own), so a test can see which rows it wrote."""
    from scalellm_tpu_torch.ops import grouped_matmul as G

    R, K = xs.shape
    E, N, _ = w.shape
    rc = G._library().scalellm_grouped_matmul(xs.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(), R, K,
                                              N, E, tile, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()


# group sizes of 64 rows of K = 192 -> N = 200 (three weight tiles of 64, the
# last short): experts of 1-40 rows whose token tiles straddle the next
# expert's rows, one expert past the end of xs (its rows are cut at R), and
# no expert at all.
GMM_ROW_CASES = {
    "tiles_straddle_experts": [5, 17, 0, 1, 9, 3, 0, 20, 2],
    "last_expert_cut_at_r": [30, 0, 40],
    "all_rows_uncovered": [0, 0, 0, 0],
}


@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("case", list(GMM_ROW_CASES))
def test_grouped_matmul_kernel_writes_only_its_experts_rows(cuda, case, tile):
    from scalellm_tpu_torch.ops.grouped_matmul import plain_grouped_matmul

    sizes = np.array(GMM_ROW_CASES[case], np.int32)
    R, K, N, E = 64, 192, 200, len(sizes)
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((E, N, K)).astype(np.float32) / np.sqrt(K)).to(cuda, torch.bfloat16)
    gs = torch.from_numpy(sizes).to(cuda)
    out = torch.full((R, N), float("nan"), device=cuda)
    _gmm_into(out, xs, w, gs, tile)
    covered = min(int(sizes.sum()), R)
    want = plain_grouped_matmul(xs, w, gs)
    torch.testing.assert_close(out[:covered], want[:covered], atol=1e-4 * want.abs().max().item(), rtol=0)
    assert torch.isnan(out[covered:]).all()  # rows past the groups are never written


def test_grouped_matmul_kernel_gives_the_same_bits_on_every_call(cuda):
    from scalellm_tpu_torch.ops.grouped_matmul import TILES, grouped_matmul_cuda

    rng = np.random.default_rng(8)
    for T, n_pad, E, k in ((16, 8, 64, 6), (512, 0, 16, 4)):  # a decode step and a prefill step
        xs, sizes = _routed_rows(rng, T, E, k, 256, n_pad)
        xs = torch.from_numpy(xs).to(cuda, torch.bfloat16)
        w = torch.from_numpy(rng.standard_normal((E, 136, 256)).astype(np.float32) / 16).to(cuda, torch.bfloat16)
        gs = torch.from_numpy(sizes).to(cuda)
        for tile in range(len(TILES)):
            first = grouped_matmul_cuda(xs, w, gs, tile=tile)
            for _ in range(19):
                assert torch.equal(grouped_matmul_cuda(xs, w, gs, tile=tile), first)


def test_grouped_matmul_kernel_refuses_what_it_does_not_cover(cuda):
    from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul_cuda

    xs = torch.zeros(4, 48, dtype=torch.bfloat16, device=cuda)
    gs = torch.tensor([4, 0], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):  # K % 32
        grouped_matmul_cuda(xs, torch.zeros(2, 16, 48, dtype=torch.bfloat16, device=cuda), gs)
    with pytest.raises(NotImplementedError):  # f32
        grouped_matmul_cuda(xs[:, :32].float(), torch.zeros(2, 16, 32, device=cuda), gs)


# ---------------------------------------------------------------- MLA attention (K9, K10)
#
# Tolerance 2e-2 absolute, as for ragged paged attention: the kernels round
# p to bf16 for the second product; outputs (averages of unit-variance rows)
# are rounded to bf16.

# (q_lens, kv_lens, S, T, n_heads, latent_dim, v_dim)
MLA_CASES = {
    "decode_v2_lite": ([1] * 8, [16, 40, 90, 150, 233, 310, 480, 600], 8, 16, 16, 576, 512),
    "decode_padding_slots": ([1] * 3, [5, 33, 64], 8, 16, 4, 576, 512),
    "mixed_v2_lite": ([37, 64, 1, 1, 1, 1, 1, 1], [37, 200, 17, 90, 301, 5, 77, 600], 16, 256, 16, 576, 512),
    "mixed_two_head_groups": ([9, 1, 1], [40, 70, 3], 4, 16, 20, 576, 512),
    # The split-KV decode at long contexts: one 8192-token sequence, 64 of
    # 128-2048 tokens, full V2's 128 heads (8 head groups), and pieces past
    # kv_len (the block table is as long as the 2048-token slot's).
    "decode_8192": ([1], [8192], 1, 16, 16, 576, 512),
    "decode_64_of_128_2048": ([1] * 64, [128 + round(i * 1920 / 63) for i in range(64)], 64, 64, 16, 576, 512),
    "decode_h128": ([1] * 4, [100, 700, 1500, 33], 4, 16, 128, 576, 512),
    "decode_splits_past_kv_len": ([1] * 4, [2048, 70, 1, 300], 4, 16, 16, 576, 512),
    # Chunks that are no multiple of a tile's tokens (2 or 4), beside
    # decodes of 900 and 1024 tokens, a 1-token context and a padding slot.
    "mixed_odd_chunks": ([37, 17, 1, 1, 5, 3, 1], [37, 300, 900, 1024, 5, 90, 1], 8, 128, 16, 576, 512),
}
# The decode cases whose slots the plan cuts into more than one piece.
MLA_SPLIT_CASES = ["decode_v2_lite", "decode_8192", "decode_64_of_128_2048", "decode_h128",
                   "decode_splits_past_kv_len"]


def _mla_case(device, case, seed=0):
    from torch_port_util import latent_batch

    q_lens, kv_lens, S, T, H, Dc, _ = MLA_CASES[case]
    rng = np.random.default_rng(seed)
    return _on(latent_batch(rng, q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=H, latent_dim=Dc), device)


@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_kernels_match_plain_versions(cuda, case):
    from torch_port_util import latent_batch

    from scalellm_tpu_torch.ops import mla_attention as M

    q_lens, kv_lens, S, T, H, Dc, vd = MLA_CASES[case]
    rng = np.random.default_rng(0)
    inputs = _on(latent_batch(rng, q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=H,
                              latent_dim=Dc), cuda)
    decode_only = all(n == 1 for n in q_lens)
    kw = dict(sm_scale=0.0723, v_dim=vd, decode_only=decode_only)
    kernel = M.mla_decode_attention_cuda if decode_only else M.mla_prefill_attention_cuda
    before = kernel.launches
    got = M.mla_paged_attention(**inputs, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = M.plain_mla_paged_attention(**inputs, **kw)
    assert got.shape == (T, H, vd) and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert torch.all(got[sum(q_lens):] == 0)
    if decode_only:  # the same batch through K10 gives the same rows
        mixed = M.mla_prefill_attention_cuda(**{k: v for k, v in inputs.items()}, sm_scale=0.0723, v_dim=vd)
        torch.testing.assert_close(mixed.float(), got.float(), atol=TOL, rtol=0)


@pytest.mark.parametrize("case", MLA_SPLIT_CASES)
def test_mla_split_decode_passes_the_row_check_that_fails_a_lost_piece(cuda, case):
    """K9 within ATTENTION_REL_TOL of each (token, head) row's size, as its
    plain split-and-merge is; that split-and-merge with the longest slot's
    middle piece left out fails the check."""
    from scalellm_tpu_torch.ops import mla_attention as M

    q_lens, kv_lens, S, T, H, Dc, vd = MLA_CASES[case]
    inputs = _mla_case(cuda, case)
    args = (inputs["q"], inputs["k_pages"], inputs["kv_lens"], inputs["page_indices"])
    capacity = inputs["page_indices"].shape[1] * inputs["k_pages"].shape[1]
    splits, split_len = M.mla_split_plan(capacity, S, -(-H // M.HEAD_GROUP),
                                         torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert splits > 1
    got = M.mla_decode_attention_cuda(*args, sm_scale=0.0723, v_dim=vd)
    torch.cuda.synchronize()
    want = M.plain_mla_decode(*args, sm_scale=0.0723, v_dim=vd)
    _assert_matches_plain(got, want, len(q_lens))
    merged = M.plain_mla_split_decode(*args, sm_scale=0.0723, v_dim=vd)
    assert attention_row_rel_err(torch, merged, want) <= ATTENTION_REL_TOL
    s = max(range(len(kv_lens)), key=lambda i: kv_lens[i])
    drop = (s, (kv_lens[s] - 1) // split_len // 2)
    lost = M.plain_mla_split_decode(*args, sm_scale=0.0723, v_dim=vd, drop=drop)
    assert attention_row_rel_err(torch, lost, want) > ATTENTION_REL_TOL
    assert attention_row_rel_err(torch, got, lost) > ATTENTION_REL_TOL


@pytest.mark.parametrize("case", ["mixed_v2_lite", "mixed_two_head_groups", "mixed_odd_chunks"])
def test_mla_prefill_passes_the_row_check(cuda, case):
    """K10 on the mixed batches within TOL and row by row within
    ATTENTION_REL_TOL; padding rows zero."""
    from scalellm_tpu_torch.ops import mla_attention as M

    q_lens = MLA_CASES[case][0]
    inputs = _mla_case(cuda, case)
    got = M.mla_prefill_attention_cuda(**inputs, sm_scale=0.0723, v_dim=512)
    torch.cuda.synchronize()
    want = M.plain_mla_prefill(**inputs, sm_scale=0.0723, v_dim=512)
    _assert_matches_plain(got, want, sum(q_lens))


@pytest.mark.parametrize("batch", ["decode", "mixed"])
def test_mla_kernels_give_the_same_bits_on_every_call(cuda, batch):
    """No float atomics: 20 calls give the same bits (K9 on a decode batch
    of split blocks, K10 on a mixed one of tiles and split blocks), with the
    merge's scratch allocated anew on each call."""
    from scalellm_tpu_torch.ops import mla_attention as M

    if batch == "decode":
        inputs = _mla_case(cuda, "decode_splits_past_kv_len")
        call = lambda: M.mla_decode_attention_cuda(inputs["q"], inputs["k_pages"], inputs["kv_lens"],
                                                   inputs["page_indices"], sm_scale=0.0723, v_dim=512)
    else:
        inputs = _mla_case(cuda, "mixed_odd_chunks")
        call = lambda: M.mla_prefill_attention_cuda(**inputs, sm_scale=0.0723, v_dim=512)
    first = call()
    for _ in range(19):
        assert torch.equal(call(), first)


def test_mla_kernels_refuse_what_they_do_not_cover(cuda):
    from torch_port_util import latent_batch

    from scalellm_tpu_torch.ops import mla_attention as M

    rng = np.random.default_rng(1)
    inputs = _on(latent_batch(rng, q_lens=[1], kv_lens=[5], S=1, T=1, n_heads=4, latent_dim=576), cuda)
    with pytest.raises(NotImplementedError):
        M.mla_paged_attention(**inputs, sm_scale=0.1, v_dim=512, k_scale=0.5)
    with pytest.raises(NotImplementedError):  # only v_dim 512
        M.mla_paged_attention(**inputs, sm_scale=0.1, v_dim=256)
    with pytest.raises(NotImplementedError):
        M.mla_paged_attention(**{**inputs, "q": inputs["q"].float()}, sm_scale=0.1, v_dim=512)
    narrow = _on(latent_batch(rng, q_lens=[1], kv_lens=[5], S=1, T=1, n_heads=4, latent_dim=192), cuda)
    with pytest.raises(NotImplementedError):  # only a 576-wide latent
        M.mla_paged_attention(**narrow, sm_scale=0.1, v_dim=128)


# ---------------------------------------------------------------- routed quantized experts (K7, K8)
#
# Tolerance: the kernels and their plain versions multiply the same exact
# products (bf16 activations times int4/int8 weights, exact in f32), sum
# them in f32 in another order, then scale per group (int4) or per channel
# (int8): 1e-4 of the output's largest magnitude. K7 and K8 share their
# arithmetic, so K8's outputs equal two K7 calls bit for bit.


def _quant_experts(rng, E, K, N, bits, G, device):
    from scalellm_tpu_torch.ops.moe_quant import quantize_experts_int4, quantize_experts_int8

    w = torch.from_numpy((rng.standard_normal((E, N, K)) * K ** -0.5).astype(np.float32)).to(device)
    return quantize_experts_int4(w, G) if bits == 4 else quantize_experts_int8(w)


# (tokens, padding tokens among them, experts, top-k, K, N, bits, int4 group)
MOE_QUANT_CASES = {
    # DeepSeek-V2-Lite's decode step: 8 tokens padded to 16, 96 rows.
    "v2_lite_gate_up_int4": (16, 8, 64, 6, 2048, 1408, 4, 128),
    "v2_lite_down_int4_11_groups": (16, 8, 64, 6, 1408, 2048, 4, 128),
    "v2_lite_gate_up_int8": (16, 8, 64, 6, 2048, 1408, 8, 0),
    "v2_lite_down_int8": (16, 8, 64, 6, 1408, 2048, 8, 0),
    # Groups of 32 (4-byte weight loads) and experts without rows.
    "int4_g32_empty_experts": (8, 4, 16, 2, 256, 64, 4, 32),
    # 192 rows over 8 experts: each expert walks two or more boxes of 16 rows.
    "t32_row_tiles": (32, 0, 8, 6, 256, 128, 4, 128),
    # N = 264, no multiple of a block's rows (64-128): a last block of 8.
    "n264_ragged_row_block": (16, 8, 16, 4, 256, 264, 4, 128),
    # G = 96 (spans of 32) at K = 288, no multiple of the 128-K chunk.
    "int4_g96_k288": (16, 0, 16, 4, 288, 136, 4, 96),
    # 11 groups of 32 (K = 352) and an int8 K of 192: a last chunk past K.
    "int4_g32_k352": (8, 0, 8, 2, 352, 64, 4, 32),
    "int8_k192": (16, 0, 16, 4, 192, 128, 8, 0),
    # Two rows in all: x's box of 8 rows reaches past R.
    "two_rows": (1, 0, 8, 2, 256, 64, 4, 128),
    # Qwen1.5-MoE-A2.7B's INT4 decode step: 60 experts, top-4, 64 rows;
    # down's 11 groups take the E x groups x N scale term of the gate.
    "qwen2_moe_gate_up_int4": (16, 8, 60, 4, 2048, 1408, 4, 128),
    "qwen2_moe_down_int4_11_groups": (16, 8, 60, 4, 1408, 2048, 4, 128),
}


@pytest.mark.parametrize("case", list(MOE_QUANT_CASES))
def test_moe_quant_kernels_match_plain_versions(cuda, case):
    from scalellm_tpu_torch.ops import moe_quant as MQ

    T, n_pad, E, k, K, N, bits, G = MOE_QUANT_CASES[case]
    rng = np.random.default_rng(0)
    xs, sizes = _routed_rows(rng, T, E, k, K, n_pad)
    xs = torch.from_numpy(xs).to(cuda, torch.bfloat16)
    gs = torch.from_numpy(sizes).to(cuda)
    (qg, sg), (qu, su) = (_quant_experts(rng, E, K, N, bits, G, cuda) for _ in range(2))
    cap = min(E, T * k)
    pair, single = MQ.grouped_quant_matmul_pair_cuda, MQ.grouped_quant_matmul_cuda
    before = (pair.launches, single.launches)
    g, u = MQ.grouped_quant_matmul_pair(xs, qg, sg, qu, su, gs, max_active=cap)
    only_g = MQ.grouped_quant_matmul(xs, qg, sg, gs, max_active=cap)
    torch.cuda.synchronize()
    assert (pair.launches, single.launches) == (before[0] + 1, before[1] + 1)
    active, starts = MQ.active_experts(gs, cap), MQ.expert_starts(gs)
    want_g, want_u = MQ.plain_grouped_quant_matmul_pair(xs, qg, sg, qu, su, gs, active, starts)
    for got, want in ((g, want_g), (u, want_u)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)
    assert torch.equal(only_g, g)


def test_moe_quant_kernels_take_the_single_token_layout(cuda):
    """The T=1 layout: one token broadcast over 8 rows, row j the expert of
    top-k slot j (rows not sorted by expert), rows 6 and 7 in no group."""
    from scalellm_tpu_torch.layers.moe import single_token_layout
    from scalellm_tpu_torch.ops import moe_quant as MQ

    rng = np.random.default_rng(1)
    E, k = 64, 6
    for bits, G in ((4, 128), (8, 0)):
        (qg, sg), (qu, su) = (_quant_experts(rng, E, 2048, 1408, bits, G, cuda) for _ in range(2))
        qd, sd = _quant_experts(rng, E, 1408, 2048, bits, G, cuda)
        topk_e = torch.from_numpy(rng.permutation(E)[:k].reshape(1, k)).to(cuda)
        topk_w = torch.rand(1, k, device=cuda)
        Tp, sizes, starts, active, _ = single_token_layout(topk_e, topk_w, E)
        x = torch.randn(1, 2048, device=cuda).to(torch.bfloat16).expand(Tp, -1).contiguous()
        h = torch.randn(Tp, 1408, device=cuda).to(torch.bfloat16)
        g, u = MQ.grouped_quant_matmul_pair(x, qg, sg, qu, su, sizes, active=active, starts=starts, max_active=k)
        d = MQ.grouped_quant_matmul(h, qd, sd, sizes, active=active, starts=starts, max_active=k)
        torch.cuda.synchronize()
        want_g, _ = MQ.plain_grouped_quant_matmul_pair(x, qg, sg, qu, su, sizes, active, starts)
        want_d = MQ.plain_grouped_quant_matmul(h, qd, sd, sizes, active, starts)
        for got, want in ((g, want_g), (d, want_d)):
            torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)
            assert torch.all(got[k:] == 0)


@pytest.mark.parametrize("bits", [4, 8])
def test_moe_quant_kernels_walk_an_expert_of_200_rows(cuda, bits):
    """256 rows, 200 of them one expert's (its weights re-read for each box
    of rows), one expert without rows and 4 rows outside every group."""
    from scalellm_tpu_torch.ops import moe_quant as MQ

    rng = np.random.default_rng(4)
    E, K, N = 4, 256, 128
    sizes = torch.tensor([200, 30, 0, 22], dtype=torch.int32, device=cuda)
    xs = torch.from_numpy(rng.standard_normal((256, K)).astype(np.float32)).to(cuda, torch.bfloat16)
    (qg, sg), (qu, su) = (_quant_experts(rng, E, K, N, bits, 128, cuda) for _ in range(2))
    active, starts = MQ.active_experts(sizes), MQ.expert_starts(sizes)
    g, u = MQ.grouped_quant_matmul_pair_cuda(xs, qg, sg, qu, su, sizes, active, starts)
    only_u = MQ.grouped_quant_matmul_cuda(xs, qu, su, sizes, active, starts)
    torch.cuda.synchronize()
    want_g, want_u = MQ.plain_grouped_quant_matmul_pair(xs, qg, sg, qu, su, sizes, active, starts)
    for got, want in ((g, want_g), (u, want_u)):
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)
        assert torch.all(got[252:] == 0)
    assert torch.equal(only_u, u)


@pytest.mark.parametrize("bits", [4, 8])
def test_moe_quant_kernel_fragment_order(cuda, bits):
    """One nonzero weight a row, every scale 1: row n of expert e holds v(n)
    at K = (7 n + 37 e + 3) % K, so out[t, n] = v(n) * xs[t, that K], exact.
    A K, column or row out of place moves the output to another element of
    xs. N = 264 (a last row block of 8), rows of 3 experts in the T=1
    order (starts not sorted) and one row outside every group."""
    from scalellm_tpu_torch.ops import moe_quant as MQ

    E, K, N, R = 3, 512, 264, 9
    sizes = torch.tensor([3, 2, 3], dtype=torch.int32)
    starts = torch.tensor([5, 0, 2], dtype=torch.int32)
    n = torch.arange(N)
    v = (n % 15) - 7
    v[v == 0] = 7
    cols = torch.stack([(7 * n + 37 * e + 3) % K for e in range(E)])  # [E, N]
    w = torch.zeros(E, N, K, dtype=torch.int32)
    w.scatter_(2, cols[..., None], v.expand(E, N)[..., None].to(torch.int32))
    if bits == 4:
        qw = ((w[..., 0::2] & 0xF) | ((w[..., 1::2] & 0xF) << 4)).to(torch.uint8).view(torch.int8)
        sc = torch.ones(E, K // 128, N, dtype=torch.bfloat16)
    else:
        qw, sc = w.to(torch.int8), torch.ones(E, N)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((R, K)).astype(np.float32)).to(torch.bfloat16)
    active = torch.tensor([2, 0, 1], dtype=torch.int32)
    got = MQ.grouped_quant_matmul_cuda(x.to(cuda), qw.to(cuda), sc.to(cuda), sizes.to(cuda), active.to(cuda),
                                       starts.to(cuda))
    torch.cuda.synchronize()
    want = torch.zeros(R, N)
    for e in range(E):
        rows = slice(int(starts[e]), int(starts[e] + sizes[e]))
        want[rows] = v.float() * x[rows].float()[:, cols[e]]
    assert torch.equal(got.cpu(), want)


def test_moe_quant_kernels_give_the_same_bits_on_every_call(cuda):
    """20 calls of K8 and K7 at the T=1 layout and at the decode step (96
    rows, 64 experts) give the same bits: no atomics, a fixed fold order."""
    from scalellm_tpu_torch.layers.moe import single_token_layout
    from scalellm_tpu_torch.ops import moe_quant as MQ

    rng = np.random.default_rng(7)
    E, k, D, F = 64, 6, 2048, 1408
    (qg, sg), (qu, su) = (_quant_experts(rng, E, D, F, 4, 128, cuda) for _ in range(2))
    qd, sd = _quant_experts(rng, E, F, D, 4, 128, cuda)
    topk_e = torch.from_numpy(rng.permutation(E)[:k].reshape(1, k)).to(cuda)
    Tp, sizes1, starts1, active1, _ = single_token_layout(topk_e, torch.ones(1, k, device=cuda), E)
    xs, sizes = _routed_rows(rng, 16, E, k, D, 8)
    xs, sizes = torch.from_numpy(xs).to(cuda, torch.bfloat16), torch.from_numpy(sizes).to(cuda)
    layouts = [(xs[:Tp].contiguous(), sizes1, active1, starts1),
               (xs, sizes, MQ.active_experts(sizes, E), MQ.expert_starts(sizes))]
    for x, gs, active, starts in layouts:
        h = x[:, :F].contiguous()
        calls = lambda: (*MQ.grouped_quant_matmul_pair_cuda(x, qg, sg, qu, su, gs, active, starts),
                         MQ.grouped_quant_matmul_cuda(h, qd, sd, gs, active, starts))
        first = calls()
        for _ in range(19):
            assert all(torch.equal(a, b) for a, b in zip(calls(), first))


def test_moe_quant_dispatch_takes_the_grouped_gemm_past_256_rows(cuda):
    from scalellm_tpu_torch.ops import moe_quant as MQ
    from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul_cuda

    rng = np.random.default_rng(2)
    T, E, k, K, N = 64, 16, 6, 256, 128
    xs, sizes = _routed_rows(rng, T, E, k, K)
    xs = torch.from_numpy(xs).to(cuda, torch.bfloat16)
    gs = torch.from_numpy(sizes).to(cuda)
    for bits, G in ((4, 128), (8, 0)):
        qw, sc = _quant_experts(rng, E, K, N, bits, G, cuda)
        counters = (grouped_matmul_cuda, MQ.grouped_quant_matmul_cuda, MQ.expert_dequant_cuda)
        before = [c.launches for c in counters]
        got = MQ.grouped_quant_matmul(xs, qw, sc, gs, max_active=E)
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == [before[0] + 1, before[1], before[2] + (bits == 4)]
        want = MQ.grouped_quant_matmul(xs, qw, sc, gs, max_active=E, variant="plain")
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)
        if bits == 4:  # the dequantization kernel: q * s rounded once, natural K order
            assert torch.equal(MQ.dequantize_experts_bf16(qw, sc, K), MQ.plain_dequantize_experts_bf16(qw, sc, K))


# (experts, N, K, G): DeepSeek-V2-Lite's gate/up and down widths at G =
# 128 and 32 (a 16-byte word of packed weights in one group), then shapes
# the byte path takes (K % 8 or G % 8 not 0).
EXPERT_DEQUANT_CASES = {
    "v2_lite_gate_up_g128": (4, 1408, 2048, 128),
    "v2_lite_down_g128": (4, 2048, 1408, 128),
    "v2_lite_down_g32": (3, 2048, 1408, 32),
    "bytes_g12": (3, 40, 36, 12),
    "bytes_k6_g3": (2, 24, 6, 3),
}


@pytest.mark.parametrize("case", list(EXPERT_DEQUANT_CASES))
def test_expert_dequant_kernel_gives_the_plain_versions_bits(cuda, case):
    from scalellm_tpu_torch.ops import moe_quant as MQ

    E, N, K, G = EXPERT_DEQUANT_CASES[case]
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal((E, N, K)).astype(np.float32) * 0.05)
    qw, sc = MQ.quantize_experts_int4(w, G)
    qw, sc = qw.to(cuda), sc.to(cuda)
    before = MQ.expert_dequant_cuda.launches
    got = MQ.dequantize_experts_bf16(qw, sc, K)
    torch.cuda.synchronize()
    assert MQ.expert_dequant_cuda.launches == before + 1
    want = MQ.plain_dequantize_experts_bf16(qw, sc, K)
    assert got.shape == (E, N, K) and torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_expert_dequant_kernel_refuses_what_it_does_not_cover(cuda):
    from scalellm_tpu_torch.ops import moe_quant as MQ

    qw = torch.zeros(2, 16, 64, dtype=torch.int8, device=cuda)
    sc = torch.ones(2, 4, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):  # f32 scales
        MQ.expert_dequant_cuda(qw, sc.float(), 128)
    with pytest.raises(NotImplementedError):  # 3 groups do not divide K = 128
        MQ.expert_dequant_cuda(qw, sc[:, :3].contiguous(), 128)
    with pytest.raises(NotImplementedError):  # K does not match the packed rows
        MQ.expert_dequant_cuda(qw, sc, 96)
    with pytest.raises(ValueError):  # CPU tensors take the plain version, not the kernel
        MQ.expert_dequant_cuda(qw.cpu(), sc.cpu(), 128)


def test_moe_quant_kernels_refuse_what_they_do_not_cover(cuda):
    from scalellm_tpu_torch.ops import moe_quant as MQ

    rng = np.random.default_rng(3)
    gs = torch.tensor([3, 0, 1, 0], dtype=torch.int32, device=cuda)
    act, st = MQ.active_experts(gs), MQ.expert_starts(gs)
    xs = torch.zeros(4, 256, dtype=torch.bfloat16, device=cuda)
    qw, sc = _quant_experts(rng, 4, 256, 64, 4, 16, cuda)
    with pytest.raises(NotImplementedError):  # int4 G % 32
        MQ.grouped_quant_matmul_cuda(xs, qw, sc, gs, act, st)
    qw, sc = _quant_experts(rng, 4, 96, 64, 8, 0, cuda)
    with pytest.raises(NotImplementedError):  # int8 K % 64
        MQ.grouped_quant_matmul_cuda(xs[:, :96].contiguous(), qw, sc, gs, act, st)
    qw, sc = _quant_experts(rng, 4, 256, 64, 4, 32, cuda)
    with pytest.raises(NotImplementedError):  # f32 activations
        MQ.grouped_quant_matmul_cuda(xs.float(), qw, sc, gs, act, st)


# ---------------------------------------------------------------- small-M variants and the probe (K12)
#
# gemv and w4a8g against plain_gemv / plain_w4a8g: the products are exact on
# both sides and the f32 sums run in another order; w4a8g's activation
# quantization is K2's (a rare +-1 in a quantized activation where rsqrt's
# last bit differs); outputs are rounded to bf16: the tolerance of the other
# quantized matmuls (_check_quant). The stream probe does the same f32
# operations as plain_stream in the same order (the product and the
# addition after it fused on both sides): equal after the bf16 rounding.

# (M, K, N, G, bits, asym, rms, scales dtype)
GEMV_CASES = {
    "m1_int4": (1, 512, 64, 128, 4, False, False, torch.float32),
    "m5_g32_asym_rms_ragged_n": (5, 1024, 96, 32, 4, True, "bf16", torch.float32),
    "m16_8b_qkv_rms": (16, 4096, 6144, 128, 4, False, "bf16", torch.float32),
    "m64_8b_down_split_k": (64, 14336, 512, 128, 4, False, False, torch.float32),
    "m8_int8_bf16_scales": (8, 4096, 1024, 128, 8, False, False, torch.bfloat16),
    "m33_int8_asym": (33, 2048, 256, 128, 8, True, False, torch.float32),
}


@pytest.mark.parametrize("variant", ["gemv", "w4a8g"])
@pytest.mark.parametrize("case", list(GEMV_CASES))
def test_small_m_kernels_match_plain_versions(cuda, case, variant):
    from scalellm_tpu_torch.ops import quant_matmul as Q

    M, K, N, G, bits, asym, rms, sdt = GEMV_CASES[case]
    if variant == "w4a8g" and G % 128:
        G = 128
    t = _quant_case(cuda, M=M, K=K, N=N, G=G, bits=bits, asym=asym, rms=rms, scales_dtype=sdt)
    args = (t["x"], t["qweight"], t["scales"], t["zeros"], bits)
    if variant == "gemv":
        kernel, plain, extra = Q.quant_gemv_cuda, Q.plain_gemv, ()
    else:
        kernel, plain, extra = Q.quant_w4a8_gemv_cuda, Q.plain_w4a8g, (min(K, 2048),)
    before = kernel.launches
    got = kernel(*args, *extra, t["rms_gamma"], 1e-5)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check_quant(got, plain(*args, *extra, t["rms_gamma"], 1e-5).to(torch.bfloat16))


# (M, K, N, G, bits, asym, scales dtype, block_k)
STREAM_CASES = {
    "m4_int4": (4, 4096, 6144, 128, 4, False, torch.float32, 2048),
    "m3_asym_ragged_n": (3, 2048, 1000, 128, 4, True, torch.float32, 2048),
    "m70_int8_bf16_scales": (70, 4096, 4096, 128, 8, False, torch.bfloat16, 1024),
    "m16_g32_asym": (16, 1024, 256, 32, 4, True, torch.float32, 256),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_probe_matches_plain_version_exactly(cuda, case):
    from scalellm_tpu_torch.ops import quant_matmul as Q

    M, K, N, G, bits, asym, sdt, block_k = STREAM_CASES[case]
    t = _quant_case(cuda, M=M, K=K, N=N, G=G, bits=bits, asym=asym, rms=False, scales_dtype=sdt)
    args = (t["x"], t["qweight"], t["scales"], t["zeros"], bits, block_k)
    before = Q.quant_stream_probe_cuda.launches
    got = Q.quant_stream_probe_cuda(*args)
    torch.cuda.synchronize()
    assert Q.quant_stream_probe_cuda.launches == before + 1
    assert torch.equal(got, Q.plain_stream(*args).to(torch.bfloat16))
    weights_only = Q.quant_stream_probe_cuda(*args, weights_only=True)
    torch.cuda.synchronize()
    assert torch.isfinite(weights_only).all()


def test_dispatcher_takes_the_small_m_variants_to_their_kernels(cuda):
    """quant_matmul with variant gemv / w4a8g / stream launches that kernel
    at M <= 64 (gemv and w4a8g go to dequant above), and agrees with
    plain_quant_matmul."""
    from scalellm_tpu_torch.ops import quant_matmul as Q

    wrappers = dict(gemv=Q.quant_gemv_cuda, w4a8g=Q.quant_w4a8_gemv_cuda,
                    stream=Q.quant_stream_probe_cuda, dequant=Q.quant_matmul_dequant_cuda)
    for M, variant, want in ((16, "gemv", "gemv"), (16, "w4a8g", "w4a8g"), (16, "stream", "stream"),
                             (65, "gemv", "dequant"), (65, "w4a8g", "dequant")):
        t = _quant_case(cuda, M=M, K=1024, N=256, G=128, bits=4, asym=False, rms="bf16",
                        scales_dtype=torch.bfloat16)
        kw = dict(bits=4, symmetric=True, variant=variant, rms_gamma=t["rms_gamma"], rms_eps=1e-5)
        before = {k: w.launches for k, w in wrappers.items()}
        got = Q.quant_matmul(t["x"], t["qweight"], t["scales"], **kw)
        torch.cuda.synchronize()
        assert {k: w.launches - before[k] for k, w in wrappers.items()} == \
            {k: int(k == want) for k in wrappers}, (M, variant)
        want_out = Q.plain_quant_matmul(t["x"], t["qweight"], t["scales"], **kw)
        if variant == "stream":
            assert torch.equal(got, want_out)
        else:
            _check_quant(got, want_out)


# The gemv kernel on the small-M tensor-core mainloop (csrc/quant_small_m.cuh):
# every bits / zero points / G (32, 96, 128) combination, M = 1, 7, 16, 33,
# 64, ragged N, blocks of one K slice (N >= 15206 on 132 SMs; 4 to 8 row
# warps) and of 2 or 4, the RMSNorm prologue. Tolerance: _check_quant's share of the output's
# magnitude (the tile kernel's). (M, K, N, G, bits, asym, rms, scales dtype)
GEMV_MAINLOOP_CASES = {
    "m1_int4_g128_one_slice": (1, 1024, 16384, 128, 4, False, False, torch.float32),
    "m7_int4_asym_g32_rms_ragged_n": (7, 1024, 200, 32, 4, True, "bf16", torch.float32),
    "m16_int4_g32": (16, 1024, 128, 32, 4, False, False, torch.bfloat16),
    "m33_int4_asym_g96": (33, 1152, 256, 96, 4, True, False, torch.float32),
    "m7_int4_g96_rms_ragged_n": (7, 1152, 1000, 96, 4, False, "bf16", torch.bfloat16),
    "m64_int4_asym_g128_rms_two_slices": (64, 4096, 9000, 128, 4, True, True, torch.float32),
    "m64_int4_asym_g32": (64, 2048, 320, 32, 4, True, False, torch.bfloat16),
    "m16_int8_g32_one_slice_ragged_n": (16, 1024, 16400, 32, 8, False, False, torch.bfloat16),
    "m1_int8_asym_g32": (1, 512, 96, 32, 8, True, False, torch.float32),
    "m64_int8_g96_rms": (64, 1152, 512, 96, 8, False, "bf16", torch.bfloat16),
    "m16_int8_asym_g96": (16, 1152, 384, 96, 8, True, False, torch.float32),
    "m7_int8_g128": (7, 1024, 256, 128, 8, False, False, torch.bfloat16),
    "m16_int8_asym_g128_ragged_n": (16, 2048, 1030, 128, 8, True, False, torch.bfloat16),
    "m33_int8_asym_g128_rms": (33, 4096, 2048, 128, 8, True, True, torch.float32),
    # One-slice blocks of fewer row warps (the kernel's gemv_row_warps on
    # 132 SMs): 7 (112 rows, N = 28672) and 5 (80 rows, N = 17000, ragged).
    "m16_int4_asym_rms_seven_row_warps": (16, 1024, 28672, 128, 4, True, "bf16", torch.float32),
    "m7_int8_g32_five_row_warps_ragged_n": (7, 1024, 17000, 32, 8, False, False, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(GEMV_MAINLOOP_CASES))
def test_gemv_kernel_matches_plain_version(cuda, case):
    from scalellm_tpu_torch.ops import quant_matmul as Q

    M, K, N, G, bits, asym, rms, sdt = GEMV_MAINLOOP_CASES[case]
    t = _quant_case(cuda, M=M, K=K, N=N, G=G, bits=bits, asym=asym, rms=rms, scales_dtype=sdt)
    args = (t["x"], t["qweight"], t["scales"], t["zeros"], bits, t["rms_gamma"], 1e-5)
    before = Q.quant_gemv_cuda.launches
    got = Q.quant_gemv_cuda(*args)
    torch.cuda.synchronize()
    assert Q.quant_gemv_cuda.launches == before + 1
    _check_quant(got, Q.plain_gemv(*args).to(torch.bfloat16))


def test_gemv_kernel_gives_the_same_bits_on_every_call(cuda):
    """20 calls, K slices and the prologue included: the sums run in a fixed
    order (no atomics)."""
    from scalellm_tpu_torch.ops import quant_matmul as Q

    t = _quant_case(cuda, M=16, K=4096, N=2048, G=128, bits=4, asym=True, rms="bf16",
                    scales_dtype=torch.float32)
    args = (t["x"], t["qweight"], t["scales"], t["zeros"], 4, t["rms_gamma"], 1e-5)
    first = Q.quant_gemv_cuda(*args)
    for _ in range(19):
        assert torch.equal(Q.quant_gemv_cuda(*args), first)


@pytest.mark.parametrize("bits", [4, 8])
def test_gemv_kernel_fragment_order(cuda, bits):
    """One nonzero weight per column (3 at K = n, scale 1, K = 128): the
    output is 3 x[:, n] exactly, which holds only if every unpacked nibble
    (or byte) lands at its own K in the mma fragment and x is read with the
    same permutation of K."""
    from scalellm_tpu_torch.ops import quant_matmul as Q

    M, K, N = 24, 128, 128
    w = torch.zeros(N, K, dtype=torch.int32)
    w[torch.arange(N), torch.arange(N)] = 3
    if bits == 4:
        qweight = ((w[:, 0::2] & 0xF) | ((w[:, 1::2] & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    else:
        qweight = w.to(torch.int8)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    got = Q.quant_gemv_cuda(x.to(cuda), qweight.to(cuda), torch.ones(1, N, device=cuda), None, bits)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), (3 * x.float()).to(torch.bfloat16))


def test_small_m_kernels_refuse_what_they_do_not_cover(cuda):
    from scalellm_tpu_torch.ops import quant_matmul as Q

    t = _quant_case(cuda, M=8, K=256, N=64, G=128, bits=4, asym=False, rms=False,
                    scales_dtype=torch.float32)
    args = (t["qweight"], t["scales"], None, 4)
    with pytest.raises(NotImplementedError):
        Q.quant_gemv_cuda(t["x"].repeat(16, 1), *args)  # M = 128
    with pytest.raises(NotImplementedError):
        Q.quant_w4a8_gemv_cuda(t["x"].float(), *args, 256)
    g64 = _quant_case(cuda, M=8, K=256, N=64, G=64, bits=4, asym=False, rms=False,
                      scales_dtype=torch.float32)
    with pytest.raises(NotImplementedError):  # w4a8g needs G % 128 == 0
        Q.quant_w4a8_gemv_cuda(g64["x"], g64["qweight"], g64["scales"], None, 4, 256)


# ---------------------------------------------------------------- W4A8 mainloop (K2, K12b)
#
# K2 (w4a8) and K12b (w4a8g) on the integer small-M mainloop of
# csrc/quant_small_m.cuh, against plain_w4a8 / plain_w4a8g: the integer dots
# are exact on both sides, the f32 sums run in another order (K slices),
# _check_quant's tolerance. Every token tile (M 1, 5, 8, 16, 33, 64), int4
# and int8, symmetric and with zero points, G 128 and 256, f32 and bf16
# scales, the prologue (one k-block spanning K), several k-blocks, N that
# leaves a partial block, blocks of one K slice (N >= 15206 on 132 SMs; 7
# row warps at N = 28672) and of 2 or 4. (M, K, N, G, bits, asym, rms,
# scales dtype, block_k)
W4A8_CASES = {
    "m1_int4": (1, 512, 64, 128, 4, False, False, torch.float32, 256),
    "m8_int4_asym_rms": (8, 1024, 128, 128, 4, True, True, torch.float32, 1024),
    "m16_int4_bf16_scales": (16, 4096, 4096, 128, 4, False, "bf16", torch.bfloat16, 4096),
    "m33_int4_asym": (33, 2048, 256, 128, 4, True, False, torch.bfloat16, 1024),
    "m64_int4_kblocks": (64, 14336, 512, 128, 4, False, False, torch.float32, 2048),
    "m5_int4_g256": (5, 1024, 64, 256, 4, True, False, torch.float32, 512),
    "m8_int8": (8, 4096, 1024, 128, 8, False, False, torch.bfloat16, 2048),
    "m64_int8_asym_rms": (64, 512, 64, 128, 8, True, True, torch.float32, 512),
    # The integer mainloop's edges:
    "m1_int4_one_slice": (1, 1024, 16384, 128, 4, False, False, torch.float32, 512),
    "m1_int8_asym_ragged_n": (1, 512, 96, 128, 8, True, False, torch.float32, 256),
    "m8_int4_asym_rms_ragged_n": (8, 1024, 200, 128, 4, True, "bf16", torch.float32, 1024),
    "m8_int4_asym_seven_row_warps": (8, 1024, 28672, 128, 4, True, False, torch.bfloat16, 512),
    "m16_int4_g256_kblocks_ragged_n": (16, 4096, 1000, 256, 4, False, False, torch.bfloat16, 1024),
    "m16_int8_one_slice_ragged_n": (16, 1024, 16400, 128, 8, False, False, torch.bfloat16, 512),
    "m33_int8_asym_g256": (33, 2048, 520, 256, 8, True, False, torch.float32, 512),
    "m33_int4_rms_bf16_scales": (33, 4096, 6144, 128, 4, False, True, torch.bfloat16, 4096),
    "m64_int4_asym_down_kblocks": (64, 14336, 512, 128, 4, True, False, torch.float32, 2048),
    "m64_int8_rms_two_slices": (64, 4096, 9000, 128, 8, False, "bf16", torch.float32, 4096),
}


def _w4a8_variant(variant):
    from scalellm_tpu_torch.ops import quant_matmul as Q

    if variant == "w4a8":
        return Q.quant_matmul_w4a8_cuda, Q.plain_w4a8, Q._library, "scalellm_quant_matmul_w4a8"
    return Q.quant_w4a8_gemv_cuda, Q.plain_w4a8g, Q._gemv_library, "scalellm_quant_w4a8_gemv"


@pytest.mark.parametrize("variant", ["w4a8", "w4a8g"])
@pytest.mark.parametrize("case", list(W4A8_CASES))
def test_w4a8_kernel_matches_plain_version(cuda, case, variant):
    M, K, N, G, bits, asym, rms, sdt, block_k = W4A8_CASES[case]
    kernel, plain, _, _ = _w4a8_variant(variant)
    t = _quant_case(cuda, M=M, K=K, N=N, G=G, bits=bits, asym=asym, rms=rms, scales_dtype=sdt)
    args = (t["x"], t["qweight"], t["scales"], t["zeros"], bits, block_k, t["rms_gamma"], 1e-5)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check_quant(got, plain(*args).to(torch.bfloat16))


def test_w4a8_kernels_give_the_same_bits_on_every_call(cuda):
    """20 calls each, K slices, zero points and the prologue included: the
    sums run in a fixed order (no atomics)."""
    t = _quant_case(cuda, M=16, K=4096, N=2048, G=128, bits=4, asym=True, rms="bf16",
                    scales_dtype=torch.float32)
    for variant in ("w4a8", "w4a8g"):
        kernel = _w4a8_variant(variant)[0]
        args = (t["x"], t["qweight"], t["scales"], t["zeros"], 4, 4096, t["rms_gamma"], 1e-5)
        first = kernel(*args)
        for _ in range(19):
            assert torch.equal(kernel(*args), first)


@pytest.mark.parametrize("variant", ["w4a8", "w4a8g"])
@pytest.mark.parametrize("bits", [4, 8])
def test_w4a8_kernel_fragment_order(cuda, bits, variant):
    """One nonzero weight per column (3 at K = n, scale 1, K = 256, two
    spans): the output is 3 sx xq[:, n], which the kernel gives with the
    plain version's bits only if every nibble (or byte) lands at its own K
    in the mma fragment and xq is stored with the same permutation of K."""
    M, K, N = 24, 256, 256
    kernel, plain, _, _ = _w4a8_variant(variant)
    w = torch.zeros(N, K, dtype=torch.int32)
    w[torch.arange(N), torch.arange(N)] = 3
    if bits == 4:
        qweight = ((w[:, 0::2] & 0xF) | ((w[:, 1::2] & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    else:
        qweight = w.to(torch.int8)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    scales = torch.ones(K // 128, N)
    got = kernel(x.to(cuda), qweight.to(cuda), scales.to(cuda), None, bits, K)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), plain(x, qweight, scales, None, bits, K).to(torch.bfloat16))


@pytest.mark.parametrize("variant", ["w4a8", "w4a8g"])
@pytest.mark.parametrize("M,N", [(1, 200), (33, 1000), (64, 16400)])
def test_w4a8_kernels_write_every_row_and_none_past_m(cuda, variant, M, N):
    """Through the C entry point into a NaN-filled output of M + 5 rows:
    every element of the M rows is written (finite, and equal to the
    wrapper's result), the rows past M, which the padded token tiles
    compute, are never written."""
    from scalellm_tpu_torch.ops import quant_matmul as Q

    K, G, bits, block_k = 1024, 128, 4, 512
    kernel, _, library, entry = _w4a8_variant(variant)
    t = _quant_case(cuda, M=M, K=K, N=N, G=G, bits=bits, asym=True, rms=False, scales_dtype=torch.float32)
    out = torch.full((M + 5, N), float("nan"), dtype=torch.bfloat16, device=cuda)
    xq = torch.empty(K // 32, Q.small_m_pad(M), 32, dtype=torch.int8, device=cuda)
    xs = torch.empty(K // 64, Q.small_m_pad(M), dtype=torch.float32, device=cuda)
    slices = Q.small_m_slices(N, torch.cuda.get_device_properties(cuda).multi_processor_count)
    rc = getattr(library(), entry)(
        t["x"].data_ptr(), t["qweight"].data_ptr(), t["scales"].data_ptr(), t["zeros"].data_ptr(), None,
        xq.data_ptr(), xs.data_ptr(), out.data_ptr(), M, K, N, G, bits, 0, 0, block_k, slices, 1e-5,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = kernel(t["x"], t["qweight"], t["scales"], t["zeros"], bits, block_k)
    assert torch.equal(out[:M], want)
    assert torch.isnan(out[M:].float()).all()


# ---------------------------------------------------------------- fused quantized MLP (K11)
#
# Against plain_quant_mlp: g and u are f32 sums of exact products in another
# order; where they fall on a bf16 boundary an element of h moves by one bf16
# step; the down sums are exact products in another order: 1e-3 of the
# output's largest magnitude, a mean error below 2e-5 of it.

# (M, D, F, G, bits, asym, act)
MLP_CASES = {
    "m1_8b": (1, 4096, 14336, 128, 4, False, "silu"),
    "m8_8b_asym": (8, 4096, 14336, 128, 4, True, "silu"),
    "m3_g32_gelu_asym": (3, 256, 512, 32, 4, True, "gelu"),
    "m5_int8_gelu_new": (5, 512, 256, 64, 8, True, "gelu_new"),
    "m40_g256_two_row_tiles": (40, 1024, 1024, 256, 4, False, "silu"),
    # The tensor-core kernel's edges: M = 7, 16, 33, 64 (every token tile),
    # int8 and G = 96, bf16 scales, a large D, one K slice in the down phase
    # (D >= 15206 on 132 SMs) and 2 or 4.
    "m7_int8_g96_asym": (7, 1152, 384, 96, 8, True, "silu"),
    "m16_8b_int4_g32_asym": (16, 4096, 1024, 32, 4, True, "gelu"),
    "m33_int4_g128": (33, 2048, 1024, 128, 4, False, "silu"),
    "m64_8b": (64, 4096, 14336, 128, 4, False, "silu"),
    "m64_int8_asym_large_d": (64, 16384, 256, 128, 8, True, "gelu_new"),
    "m16_int4_one_down_slice": (16, 16384, 512, 128, 4, False, "silu"),
}


def _mlp_case(device, M, D, F, G, bits, asym, seed=0):
    rng = np.random.default_rng(seed)
    pack = 2 if bits == 4 else 1

    def triple(K, N):
        q = torch.from_numpy(rng.integers(-128, 128, (N, K // pack), dtype=np.int8)).to(device)
        s = torch.from_numpy(rng.uniform(0.002, 0.02, (K // G, N)).astype(np.float32)).to(device)
        lo, hi = (-8, 8) if bits == 4 else (-20, 20)
        z = torch.from_numpy(rng.integers(lo, hi, (K // G, N), dtype=np.int8)).to(device) if asym else None
        return q, s, z

    x = torch.from_numpy((rng.standard_normal((M, D)) + 0.3).astype(np.float32)).to(device, torch.bfloat16)
    return x, triple(D, 2 * F), triple(F, D)


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_quant_mlp_kernel_matches_plain_version(cuda, case):
    from scalellm_tpu_torch.ops import quant_mlp as QM

    M, D, F, G, bits, asym, act = MLP_CASES[case]
    x, gate_up, down = _mlp_case(cuda, M, D, F, G, bits, asym)
    before = QM.quant_mlp_cuda.launches
    got = QM.quant_mlp(x, gate_up, down, F, bits=bits, act=act, tile_n=min(1024, F))
    torch.cuda.synchronize()
    assert QM.quant_mlp_cuda.launches == before + 1
    want = QM.plain_quant_mlp(x, gate_up, down, F, bits, act)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    diff = (got - want).abs()
    top = want.abs().max().item()
    assert diff.max().item() <= 1e-3 * top, (diff.max().item(), top)
    assert diff.mean().item() <= 2e-5 * top, (diff.mean().item(), top)


def test_quant_mlp_kernel_gives_the_same_bits_on_every_call(cuda):
    from scalellm_tpu_torch.ops import quant_mlp as QM

    x, gate_up, down = _mlp_case(cuda, 16, 2048, 2048, 128, 4, True)
    first = QM.quant_mlp_cuda(x, gate_up, down, 2048, 4, "silu")
    for _ in range(19):
        assert torch.equal(QM.quant_mlp_cuda(x, gate_up, down, 2048, 4, "silu"), first)


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_mlp_kernel_fragment_order(cuda, bits):
    """One nonzero weight a row, scale 1, D = F = 128: gate row f reads x at
    K = f (weight 3), up row f at K = f + 1 (weight 2), down row d reads h
    at F = d + 5 (weight 1). A fragment or a gate/up pairing out of place
    moves the output to other columns of x."""
    from scalellm_tpu_torch.ops import quant_mlp as QM

    M, D, F = 24, 128, 128
    idx = torch.arange(128)

    def packed(rows, cols, value):
        w = torch.zeros(rows, 128, dtype=torch.int32)
        w[idx[:rows], cols] = value
        if bits == 4:
            return ((w[:, 0::2] & 0xF) | ((w[:, 1::2] & 0xF) << 4)).to(torch.uint8).view(torch.int8)
        return w.to(torch.int8)

    gq = torch.cat([packed(F, idx, 3), packed(F, (idx + 1) % D, 2)])
    dq = packed(D, (idx + 5) % F, 1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((M, D)).astype(np.float32)).to(torch.bfloat16)
    ones = lambda n: torch.ones(1, n, device=cuda)
    got = QM.quant_mlp_cuda(x.to(cuda), (gq.to(cuda), ones(2 * F), None), (dq.to(cuda), ones(D), None), F, bits)
    torch.cuda.synchronize()
    xf = x.float()
    g, u = 3 * xf, 2 * xf[:, (idx + 1) % D]
    h = (g * torch.sigmoid(g) * u).to(torch.bfloat16).float()
    torch.testing.assert_close(got.cpu(), h[:, (idx + 5) % F], rtol=1e-2, atol=1e-6)


def test_quant_mlp_kernel_refuses_prefill(cuda):
    from scalellm_tpu_torch.ops import quant_mlp as QM

    x, gate_up, down = _mlp_case(cuda, 65, 256, 256, 128, 4, False)
    with pytest.raises(NotImplementedError):
        QM.quant_mlp(x, gate_up, down, 256, tile_n=256)


# ---------------------------------------------------------------- MoE combine


def test_moe_routed_path_is_bit_identical_across_calls(cuda):
    """The routed experts of a DeepSeek-V2-Lite MoE layer at its decode
    shape (T = 16 tokens, k = 6 of 64 experts, D = 2048, F = 1408) through
    K6 and the combine: two calls give the same bits (the combine adds each
    token's rows in a fixed order, without atomics)."""
    from scalellm_tpu_torch.layers import moe as TM

    T, E, k, D, F = 16, 64, 6, 2048, 1408
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(T, D, generator=g, device=cuda).to(torch.bfloat16)
    router = torch.randn(E, D, generator=g, device=cuda)
    gate, up = (torch.randn(2, E, F, D, generator=g, device=cuda) * D ** -0.5).to(torch.bfloat16)
    down = (torch.randn(E, D, F, generator=g, device=cuda) * F ** -0.5).to(torch.bfloat16)

    def routed():
        topk_w, topk_e = TM.softmax_topk(x, router, k)
        order, token_of, group_sizes = TM.dispatch(topk_e, E)
        y = TM.expert_ffn(x[token_of], gate, up, down, group_sizes)
        return TM.combine(y, topk_w, order, token_of, T)

    first, second = routed(), routed()
    torch.cuda.synchronize()
    assert first.shape == (T, D) and torch.isfinite(first).all()
    assert torch.equal(first, second)


# ---------------------------------------------------------------- CUDA graphs
#
# Each main-path wrapper captured in a CUDA graph (after one eager call on a
# side stream, as the executor's StepGraphs does), new values copied into its
# static inputs, two replays: each must give the bits of an eager call on
# those values. The wrappers' launch counters advance at the capture, not at
# a replay.


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _replays_give_eager_bits(fn, inputs, new_inputs, kernels):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = fn(**inputs)
        first = [o.clone() for o in (first if isinstance(first, tuple) else (first,))]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = [k.launches for k in kernels]
    with torch.cuda.graph(graph):
        out = fn(**inputs)
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    outs = out if isinstance(out, tuple) else (out,)
    for name, t in new_inputs.items():
        inputs[name].copy_(t)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([o.clone() for o in outs])
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    want = fn(**inputs)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for got in replays:
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))
    # The replays read the new values: they differ from the first call's.
    assert not torch.equal(_bits(replays[0][0]), _bits(first[0]))


def _graph_case_attention(device, case, seed):
    q_lens, kv_lens, S, T, H, Hkv, D, window, cap, page = SHAPES[case]
    return _attention_case(device, q_lens, kv_lens, S, T, H, Hkv, D, page, seed=seed)


def _graph_case_quant(device, seed, M):
    t = _quant_case(device, M=M, K=4096, N=4096, G=128, bits=4, asym=False, rms="bf16",
                    scales_dtype=torch.bfloat16, seed=seed)
    return {k: v for k, v in t.items() if v is not None}


def _graph_case_gmm(device, case, seed):
    T, n_pad, E, k, K, N, _ = GMM_CASES[case]
    rng = np.random.default_rng(seed)
    xs, sizes = _routed_rows(rng, T, E, k, K, n_pad)
    w = rng.standard_normal((E, N, K)).astype(np.float32) / np.sqrt(K)
    return dict(xs=torch.from_numpy(xs).to(device, torch.bfloat16),
                w=torch.from_numpy(w).to(device, torch.bfloat16), gs=torch.from_numpy(sizes).to(device))


def _graph_case_moe_quant(device, case, seed):
    T, n_pad, E, k, K, N, bits, G = MOE_QUANT_CASES[case]
    rng = np.random.default_rng(seed)
    xs, sizes = _routed_rows(rng, T, E, k, K, n_pad)
    (qg, sg), (qu, su) = (_quant_experts(rng, E, K, N, bits, G, device) for _ in range(2))
    return dict(xs=torch.from_numpy(xs).to(device, torch.bfloat16), gs=torch.from_numpy(sizes).to(device),
                qg=qg, sg=sg, qu=qu, su=su)


def _graph_case_dequant(device, seed):
    from scalellm_tpu_torch.ops import moe_quant as MQ

    E, N, K, G = EXPERT_DEQUANT_CASES["v2_lite_gate_up_g128"]
    rng = np.random.default_rng(seed)
    qw, sc = MQ.quantize_experts_int4(torch.from_numpy(rng.standard_normal((E, N, K)).astype(np.float32) * 0.05), G)
    return dict(qweight=qw.to(device), scales=sc.to(device))


def _graph_cases():
    """name -> (inputs of a seed, the wrapper call, the counters it advances)."""
    from scalellm_tpu_torch.ops import grouped_matmul as GM
    from scalellm_tpu_torch.ops import mla_attention as M
    from scalellm_tpu_torch.ops import moe_quant as MQ
    from scalellm_tpu_torch.ops import quant_matmul as Q
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention_cuda as k1

    def attention(case):
        return (lambda dev, seed: _graph_case_attention(dev, case, seed),
                lambda **t: k1(**t, sm_scale=0.125), [k1])

    def mla(case, kernel):
        def inputs(dev, seed):
            t = _mla_case(dev, case, seed)
            return t if kernel is M.mla_prefill_attention_cuda else {
                k: v for k, v in t.items() if k not in ("cu_q_lens", "num_seqs")}
        return inputs, lambda **t: kernel(**t, sm_scale=0.0723, v_dim=512), [kernel]

    return {
        "k1_decode": attention("decode_gqa8_d64"),
        "k1_mixed": attention("mixed_padded"),
        "k2_w4a8_prologue": (
            lambda dev, seed: _graph_case_quant(dev, seed, 16),
            lambda x, qweight, scales, rms_gamma: Q.quant_matmul_w4a8_cuda(
                x, qweight, scales, None, 4, 4096, rms_gamma, 1e-5), [Q.quant_matmul_w4a8_cuda]),
        "k4_dequant": (
            lambda dev, seed: _graph_case_quant(dev, seed, 512),
            lambda x, qweight, scales, rms_gamma: Q.quant_matmul_dequant_cuda(
                x, qweight, scales, None, 4, rms_gamma, 1e-5), [Q.quant_matmul_dequant_cuda]),
        "k6_decode": (lambda dev, seed: _graph_case_gmm(dev, "decode_r96_e64_padded", seed),
                      lambda xs, w, gs: GM.grouped_matmul_cuda(xs, w, gs), [GM.grouped_matmul_cuda]),
        "k6_prefill": (lambda dev, seed: _graph_case_gmm(dev, "prefill_wide_tile", seed),
                       lambda xs, w, gs: GM.grouped_matmul_cuda(xs, w, gs), [GM.grouped_matmul_cuda]),
        "expert_dequant": (_graph_case_dequant,
                           lambda qweight, scales: MQ.expert_dequant_cuda(qweight, scales, 2048),
                           [MQ.expert_dequant_cuda]),
        # K8 then K7 through the dispatcher: the active list and starts are
        # computed on the device inside the graph.
        "k8_k7_decode": (
            lambda dev, seed: _graph_case_moe_quant(dev, "v2_lite_gate_up_int4", seed),
            lambda xs, gs, qg, sg, qu, su: (
                *MQ.grouped_quant_matmul_pair(xs, qg, sg, qu, su, gs, max_active=64),
                MQ.grouped_quant_matmul(xs, qg, sg, gs, max_active=64)),
            [MQ.grouped_quant_matmul_pair_cuda, MQ.grouped_quant_matmul_cuda]),
        "k9_decode": mla("decode_v2_lite", M.mla_decode_attention_cuda),
        "k10_mixed": mla("mixed_v2_lite", M.mla_prefill_attention_cuda),
    }


GRAPH_CASES = ["k1_decode", "k1_mixed", "k2_w4a8_prologue", "k4_dequant", "k6_decode", "k6_prefill",
               "expert_dequant", "k8_k7_decode", "k9_decode", "k10_mixed"]


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_captured_kernel_replays_give_the_eager_bits(cuda, case):
    make, fn, kernels = _graph_cases()[case]
    _replays_give_eager_bits(fn, make(cuda, 0), make(cuda, 1), kernels)


# The executor with graphs against itself without: tiny Llama and DeepSeek-V2
# models of random weights at widths the kernels take (bf16; DeepSeek also
# with runtime INT4), a prefill step (K4, K6 after the expert dequantization)
# and decode steps (K2, K7/K8, K9) through Executor.execute: the same tokens
# and the same logits bits.

TINY_LLAMA_CFG = dict(
    model_type="llama", torch_dtype="bfloat16", hidden_size=512, intermediate_size=1024,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2, vocab_size=512,
    max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu")
TINY_DEEPSEEK_CFG = dict(
    model_type="deepseek_v2", torch_dtype="bfloat16", hidden_size=512, intermediate_size=1024,
    num_hidden_layers=3, num_attention_heads=16, vocab_size=512, max_position_embeddings=4096,
    rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="silu", q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=64, qk_rope_head_dim=64, v_head_dim=64, first_k_dense_replace=1,
    n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=256, n_shared_experts=1,
    topk_method="greedy", rope_scaling=dict(type="yarn", factor=40, original_max_position_embeddings=4096,
                                            beta_fast=32, beta_slow=1, mscale=0.707, mscale_all_dim=0.707))
# Mixtral (8 experts, top-2, GQA 4) and Qwen2-MoE (60 experts, top-4, MHA,
# the qkv bias and the gated shared expert). Qwen2-MoE's expert width 384 is
# 3 groups of 128 under INT4: no multiple of 8, as V2-Lite's and Qwen1.5's
# 11 are not.
TINY_MIXTRAL_CFG = dict(
    model_type="mixtral", torch_dtype="bfloat16", hidden_size=512, intermediate_size=1024,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2, vocab_size=512,
    max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=1e6, hidden_act="silu",
    num_local_experts=8, num_experts_per_tok=2)
TINY_QWEN2_MOE_CFG = dict(
    model_type="qwen2_moe", torch_dtype="bfloat16", hidden_size=512, intermediate_size=1024,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=8, vocab_size=512,
    max_position_embeddings=2048, rms_norm_eps=1e-6, rope_theta=1e6, hidden_act="silu", num_experts=60,
    num_experts_per_tok=4, moe_intermediate_size=384, shared_expert_intermediate_size=1024, norm_topk_prob=False)
# Gemma2 (head dim 256, GQA 2, a 32-token window on layer 0, soft caps,
# post-block norms, tied embeddings) and Qwen3 (qk norm, head dim 128).
TINY_GEMMA2_CFG = dict(
    model_type="gemma2", torch_dtype="bfloat16", hidden_size=512, intermediate_size=1024,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=256, vocab_size=512,
    max_position_embeddings=2048, rms_norm_eps=1e-6, hidden_activation="gelu_pytorch_tanh",
    query_pre_attn_scalar=256, sliding_window=32, attn_logit_softcapping=50.0, final_logit_softcapping=30.0)
TINY_QWEN3_CFG = dict(
    model_type="qwen3", torch_dtype="bfloat16", hidden_size=512, intermediate_size=1024,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2, head_dim=128, vocab_size=512,
    max_position_embeddings=2048, rms_norm_eps=1e-6, rope_theta=1e6, hidden_act="silu", tie_word_embeddings=False)
# GPT-2 (float32: K1's f32 kernel, learned positions, head dim 64), Phi
# (head dim 80, partial rotary 0.4, the parallel residual, biases), MPT
# (ALiBi at head dim 128, clip_qkv, bias-free LayerNorm) and BLOOM (ALiBi at
# head dim 64, the embedding LayerNorm).
TINY_GPT2_CFG = dict(model_type="gpt2", torch_dtype="float32", n_embd=512, n_layer=2, n_head=8, n_positions=2048,
                     vocab_size=512, activation_function="gelu_new")
TINY_PHI_CFG = dict(model_type="phi", torch_dtype="bfloat16", hidden_size=640, intermediate_size=2560,
                    num_hidden_layers=2, num_attention_heads=8, vocab_size=512, partial_rotary_factor=0.4,
                    max_position_embeddings=2048, hidden_act="gelu_new")
TINY_MPT_CFG = dict(model_type="mpt", torch_dtype="bfloat16", d_model=512, n_layers=2, n_heads=4,
                    expansion_ratio=4, vocab_size=512, max_seq_len=2048, no_bias=True,
                    attn_config=dict(alibi=True, clip_qkv=6.0))
TINY_BLOOM_CFG = dict(model_type="bloom", torch_dtype="bfloat16", hidden_size=512, n_layer=2, n_head=8,
                      vocab_size=512, layer_norm_epsilon=1e-5)
TINY_CFGS = {"llama": TINY_LLAMA_CFG, "deepseek": TINY_DEEPSEEK_CFG, "mixtral": TINY_MIXTRAL_CFG,
             "qwen2_moe": TINY_QWEN2_MOE_CFG, "gemma2": TINY_GEMMA2_CFG, "qwen3": TINY_QWEN3_CFG,
             "gpt2": TINY_GPT2_CFG, "phi": TINY_PHI_CFG, "mpt": TINY_MPT_CFG, "bloom": TINY_BLOOM_CFG}


def _random_model(device, cfg, quantize=""):
    import scalellm_tpu_torch.models  # noqa: F401  (registers the models)
    from scalellm_tpu_torch.config import QuantArgs
    from scalellm_tpu_torch.models.registry import ModelRegistry
    from scalellm_tpu_torch.quantization.runtime import quantize_model

    args = ModelRegistry.get_model_args_loader(cfg["model_type"])(dict(cfg))
    model = ModelRegistry.get_causal_lm_factory(cfg["model_type"])(args, device=device)
    g = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.05, generator=g)
    if quantize:
        model = quantize_model(model, QuantArgs(quant_method="internal", bits=4, group_size=128))
    return model


def _greedy_si(S):
    from scalellm_tpu_torch.engine.params import SamplingInputs

    return SamplingInputs(
        temperatures=np.zeros(S, np.float32), top_ks=np.zeros(S, np.int32), top_ps=np.ones(S, np.float32),
        frequency_penalties=np.zeros(S, np.float32), presence_penalties=np.zeros(S, np.float32),
        repetition_penalties=np.ones(S, np.float32), unique_token_ids=np.zeros((S, 1), np.int32),
        unique_token_counts=np.zeros((S, 1), np.int32), bias_token_ids=np.zeros((S, 1), np.int32),
        bias_values=np.zeros((S, 1), np.float32), allowed_mask=np.full((S, 1), 0xFFFFFFFF, np.uint32),
        seeds=np.zeros(S, np.uint32))


@pytest.mark.parametrize("model_name", ["llama", "deepseek", "deepseek_int4", "mixtral", "qwen2_moe_int4",
                                        "gemma2", "gemma2_int4", "qwen3", "qwen3_int4", "gpt2", "phi",
                                        "phi_int4", "mpt", "mpt_int4", "bloom"])
def test_executor_with_graphs_gives_the_eager_tokens_and_logits_bits(cuda, model_name):
    from chip_smoke import batch_inputs
    from scalellm_tpu_torch.engine.executor import Executor

    name, _, quantize = model_name.partition("_int")
    model = _random_model(cuda, TINY_CFGS[name], quantize="int4" if quantize else "")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, n).tolist() for n in (60, 37, 100)]  # 197 tokens: T = 256
    steps = [(batch_inputs(torch, [(p, 0, len(p) + 8) for p in prompts])[0], False)]
    for i in range(3):  # decode steps in one bucket (T = 16, S = 4)
        steps.append((batch_inputs(torch, [([int(rng.integers(1, 512))], len(p) + i, len(p) + 8)
                                           for p in prompts])[0], True))
    runs = {}
    for graphs in (True, False):
        ex = Executor(model, cuda)
        ex.init_kv_cache(64, 16)
        eager_logits, forward = [], ex._forward
        if graphs:
            ex.init_graphs(16, max_tokens=256, max_seqs=4, max_context_len=1024)
        else:
            ex._forward = lambda mi, d: eager_logits.append(forward(mi, d)) or eager_logits[-1]
        tokens, logprobs, logits = [], [], []
        for mi, decode_only in steps:
            out = ex.execute(mi, _greedy_si(mi.kv_lens.shape[0]), decode_only=decode_only)
            tokens.append(out.next_tokens.cpu())
            logprobs.append(out.logprobs.cpu())
            # The graph's static logits, read before the next replay.
            logits.append((ex.graphs.graphs[ex.graphs.last_key].logits if graphs else eager_logits[-1]).cpu())
        if graphs:
            assert len(ex.graphs.graphs) == 2
            assert sum(ex.graphs.replays.values()) == len(steps)
        runs[graphs] = tokens, logprobs, logits
    for got, want in zip(runs[True], runs[False]):
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


# Multi-step decode and async stepping on the card: the N-step graph's replay
# against the eager N-step loop, bit for bit (tokens and logprobs), with a
# greedy and a sampling plan and fresh inputs on the second replay; the
# device sampler's noise eagerly and in a replay; a fetch that returns while
# a later step still runs; async against sync serves with graphs.


def _sampling_si(S, seed0):
    si = _greedy_si(S)
    si.temperatures[:] = np.where(np.arange(S) % 2 == 1, 0.8, 0.0)
    si.top_ks[:] = np.where(np.arange(S) % 4 == 1, 20, 0)
    si.seeds[:] = np.arange(S, dtype=np.uint32) * 7919 + seed0
    return si


@pytest.mark.parametrize("model_name", ["llama", "deepseek", "deepseek_int4", "mixtral", "mixtral_int4",
                                        "qwen2_moe", "qwen2_moe_int4", "gemma2", "gemma2_int4", "qwen3",
                                        "qwen3_int4", "gpt2", "phi", "phi_int4", "mpt", "mpt_int4", "bloom"])
def test_multi_step_graph_replay_gives_the_eager_loop_bits(cuda, model_name):
    from chip_smoke import batch_inputs
    from scalellm_tpu_torch.engine.executor import Executor

    name, _, quantize = model_name.partition("_int")
    model = _random_model(cuda, TINY_CFGS[name], quantize="int4" if quantize else "")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, n).tolist() for n in (30, 17, 50)]  # 97 tokens: T = 128
    prefill = batch_inputs(torch, [(p, 0, len(p) + 24) for p in prompts])[0]
    decodes = [batch_inputs(torch, [([int(rng.integers(1, 512))], len(p) + 4 * i, len(p) + 24)
                                    for p in prompts])[0] for i in range(3)]
    runs = {}
    for graphs in (True, False):
        ex = Executor(model, cuda, max_top_logprobs=2)
        ex.init_kv_cache(64, 16)
        if graphs:
            ex.init_graphs(16, max_tokens=128, max_seqs=4, max_context_len=1024)
        ex.execute(prefill, _greedy_si(4))
        got = []
        # A greedy window, then two sampling windows with other seeds: a
        # replay must read the new step buffer, not what it was captured on.
        for mi, si in zip(decodes, (_greedy_si(4), _sampling_si(4, 11), _sampling_si(4, 12345))):
            out = ex.execute_multi(mi, si, 4, 16)
            got.append([t.cpu() for t in (out.next_tokens, out.logprobs, out.top_ids, out.top_logprobs)])
        if graphs:
            multi = [k for k in ex.graphs.graphs if len(k) > 4]
            assert len(multi) == 2  # the greedy plan's graph and the sampling plan's
            assert sum(ex.graphs.replays[k] for k in multi) == 3
        runs[graphs] = got, ex.kv_cache.clone()
    (got, kv_g), (want, kv_e) = runs[True], runs[False]
    for a, b in zip(got, want):
        assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))
    # The pages of the real tokens. Page 0 takes the padding rows' writes:
    # many rows to one slot (the winner is unordered), whose values MLA's
    # decode kernel leaves unset.
    assert torch.equal(_bits(kv_g[:, 1:]), _bits(kv_e[:, 1:]))
    assert got[0][0].shape == (4, 4)
    # The two sampling windows drew differently.
    assert not torch.equal(got[1][0], got[2][0]) or not torch.equal(got[1][1], got[2][1])


def test_device_sampler_noise_is_the_same_eagerly_and_in_a_replay(cuda):
    from scalellm_tpu_torch.sampling import sampler

    V = 32000
    seeds = torch.tensor([1, 2, 3, 2**32 - 5], dtype=torch.int64, device=cuda)
    logits = torch.randn(4, V, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    temps = torch.tensor([0.0, 0.7, 1.0, 1.3], device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sampler.sample(logits, temps, seeds)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        noise = sampler.gumbel_noise(seeds, V)
        picked = sampler.sample(logits, temps, seeds)
    for new in ([9, 8, 7, 6], [1, 2, 3, 2**32 - 5]):
        seeds.copy_(torch.tensor(new, dtype=torch.int64))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(noise, sampler.gumbel_noise(seeds, V))
        assert torch.equal(picked, sampler.sample(logits, temps, seeds))
        assert picked[0] == logits[0].argmax()  # the greedy row
    # The hash is integer arithmetic: the same draws as on the CPU.
    cpu = sampler.sample(logits.cpu(), temps.cpu(), seeds.cpu())
    assert torch.equal(picked.cpu(), cpu)


def test_fetch_returns_while_a_later_step_runs(cuda):
    """A step's fetch waits on its own copy's event: with the next step
    dispatched and a device spin enqueued after it, finalizing the first
    step returns while the spin still runs (a .cpu() would wait for it)."""
    from scalellm_tpu_torch.engine.executor import Executor, HostOutputs, minimal_inputs

    ex = Executor(_random_model(cuda, TINY_LLAMA_CFG), cuda)
    ex.init_kv_cache(16, 16)
    ex.init_graphs(16, max_tokens=16, max_seqs=1, max_context_len=64)
    mi, si = minimal_inputs(16, 1, 4), _greedy_si(1)
    ex.execute(mi, si)  # capture
    torch.cuda.synchronize()
    first = HostOutputs(ex.execute(mi, si), logprobs=True)
    second = HostOutputs(ex.execute(mi, si), logprobs=False)
    torch.cuda._sleep(2**31)  # about a second of device spin after the second step
    spun = torch.cuda.Event()
    spun.record()
    out = first.wait()
    assert not spun.query(), "the fetch waited for work enqueued after its step"
    assert out["next_tokens"].shape == (1,) and out["logprobs"].shape == (1,)
    torch.cuda.synchronize()
    assert second.wait()["logprobs"] is None


def test_async_serve_with_graphs_gives_the_sync_tokens(cuda, tmp_path):
    """LLM on a random-weight tiny Llama checkpoint: async and N = 4 serves
    with graphs give the sync serve's token ids (prompts prefilled in one
    step, one max_tokens: the serves run the same buckets), and take async
    and multi-step dispatches."""
    import chip_smoke
    from scalellm_tpu_torch import LLM, SamplingParams
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    # A vocabulary of the char tokenizer's 256 ids: every sampled id is text.
    cfg = dict(TINY_LLAMA_CFG, vocab_size=256, architectures=["LlamaForCausalLM"], tie_word_embeddings=False,
               bos_token_id=1, eos_token_id=2)
    chip_smoke.write_checkpoint(torch, str(tmp_path), cfg)
    prompts = ["the quick brown fox", "paged attention kernel", "abc", "decode and prefill " * 3]
    sp = SamplingParams(max_tokens=13, temperature=0.0, ignore_eos=True)
    got = {}
    for name, kw in (("sync", dict(enable_async_scheduling=False)), ("async", {}), ("ms4", dict(num_decode_steps=4))):
        before = COUNTERS.get("num_async_steps"), COUNTERS.get("num_multi_steps")
        with LLM(str(tmp_path), devices="cuda", num_blocks=64, num_handling_threads=1, **kw) as llm:
            outs = llm.generate(prompts, sp)
            got[name] = [o.outputs[0].token_ids for o in outs]
            assert all(o.usage.num_generated_tokens == 13 for o in outs)
        took = COUNTERS.get("num_async_steps") - before[0], COUNTERS.get("num_multi_steps") - before[1]
        assert took[0] > 0 if name == "async" else True
        assert took[1] > 0 if name == "ms4" else took[1] == 0
    assert got["async"] == got["sync"] and got["ms4"] == got["sync"]


# Mixtral and Qwen2-MoE on DecoderModel: a prefill batch and the decode step
# after it through the kernels (K1, K6 or K2/K4 and K8/K7 and the expert
# dequantization), then through every plain version with the kernel run's
# routing replayed layer by layer (a near-tie in a random router could
# otherwise pick another expert). Tolerance: chip_smoke.LOGITS_TOL.


@pytest.mark.parametrize("model_name", ["mixtral", "mixtral_int4", "qwen2_moe", "qwen2_moe_int4"])
def test_moe_families_kernels_match_plain_versions_with_routing_pinned(cuda, model_name):
    import functools

    from chip_smoke import LOGITS_TOL, batch_inputs
    from scalellm_tpu_torch.layers.moe import quant_expert_ffn
    from scalellm_tpu_torch.ops import grouped_matmul as G
    from scalellm_tpu_torch.ops import moe_quant as MQ
    from scalellm_tpu_torch.ops import quant_matmul as Q

    name, _, quantize = model_name.partition("_int")
    model = _random_model(cuda, TINY_CFGS[name], quantize="int4" if quantize else "")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, n).tolist() for n in (150, 61)]
    prefill, n_pages = batch_inputs(torch, [(p, 0, len(p) + 1) for p in prompts])
    decode, _ = batch_inputs(torch, [([7 + i], len(p), len(p) + 1) for i, p in enumerate(prompts)])
    routes, real_router = [], model._router
    counters = (attention.ragged_paged_attention_cuda, G.grouped_matmul_cuda, MQ.grouped_quant_matmul_cuda,
                MQ.grouped_quant_matmul_pair_cuda)
    logits = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            plain = impl == "plain"
            before = [c.launches for c in counters]
            model.attn_impl = attention.plain_ragged_paged_attention if plain else attention.ragged_paged_attention
            model.gmm_impl = G.plain_grouped_matmul if plain else G.grouped_matmul
            model.quant_impl = Q.plain_quant_matmul if plain else Q.quant_matmul
            model.qexperts_impl = functools.partial(quant_expert_ffn, variant="plain") if plain else quant_expert_ffn
            model._router = ((lambda x, w: routes.pop(0)) if plain
                             else lambda x, w: routes.append(real_router(x, w)) or routes[-1])
            kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=cuda)
            a = model.logits(model(kv, prefill.to(cuda), all_hidden=True)[: sum(map(len, prompts))])
            b = model.logits(model(kv, decode.to(cuda), decode_only=True)[: len(prompts)])
            logits[impl] = (a, b)
            launched = [c.launches - n for c, n in zip(counters, before)]
            if plain:
                assert launched == [0] * len(counters)
            else:  # K1 every layer of both steps; the experts through K6, or K8 + K7 at decode
                assert launched[0] == 2 * model.args.n_layers and sum(launched[1:]) > 0
    assert not routes
    for got, want in zip(logits["kernel"], logits["plain"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= LOGITS_TOL


# Gemma2 and Qwen3 on DecoderModel: a prefill batch and the decode step
# after it through the kernels (K1 once a layer a step; INT4: each layer's
# four quantized projections through K2 or K4, Gemma2's lm_head the tied
# bf16 embedding), then through the plain versions. Tolerance:
# chip_smoke.LOGITS_TOL.


@pytest.mark.parametrize("model_name", ["gemma2", "gemma2_int4", "qwen3", "qwen3_int4"])
def test_dense_families_kernels_match_plain_versions(cuda, model_name):
    from chip_smoke import LOGITS_TOL, batch_inputs
    from scalellm_tpu_torch.ops import quant_matmul as Q

    name, _, quantize = model_name.partition("_int")
    model = _random_model(cuda, TINY_CFGS[name], quantize="int4" if quantize else "")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, n).tolist() for n in (150, 61)]
    prefill, n_pages = batch_inputs(torch, [(p, 0, len(p) + 1) for p in prompts])
    decode, _ = batch_inputs(torch, [([7 + i], len(p), len(p) + 1) for i, p in enumerate(prompts)])
    counters = (attention.ragged_paged_attention_cuda, Q.quant_matmul_w4a8_cuda, Q.quant_matmul_dequant_cuda)
    logits = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            plain = impl == "plain"
            before = [c.launches for c in counters]
            model.attn_impl = attention.plain_ragged_paged_attention if plain else attention.ragged_paged_attention
            model.quant_impl = Q.plain_quant_matmul if plain else Q.quant_matmul
            kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=cuda)
            a = model.logits(model(kv, prefill.to(cuda), all_hidden=True)[: sum(map(len, prompts))])
            b = model.logits(model(kv, decode.to(cuda), decode_only=True)[: len(prompts)])
            logits[impl] = (a, b)
            launched = [c.launches - n for c, n in zip(counters, before)]
            L = model.args.n_layers
            assert launched == ([0, 0, 0] if plain else [2 * L, 4 * L if quantize else 0, 4 * L if quantize else 0])
    for got, want in zip(logits["kernel"], logits["plain"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= LOGITS_TOL


# GPT-2 (f32), Phi, MPT and BLOOM on DecoderModel: a prefill batch and the
# decode step after it through the kernels (K1 once a layer a step, each
# launch counted as f32, head dim 80 or ALiBi; INT4: each layer's four
# quantized projections, qkv, o, up and down, through K2 or K4), then
# through the plain versions. Tolerance: chip_smoke.LOGITS_TOL (GPT-2 in
# f32: F32_TOL).
LAYERNORM_KINDS = {"gpt2": "f32", "phi": "d80", "mpt": "alibi", "bloom": "alibi"}


@pytest.mark.parametrize("model_name", ["gpt2", "phi", "phi_int4", "mpt", "mpt_int4", "bloom"])
def test_layernorm_families_kernels_match_plain_versions(cuda, model_name):
    from chip_smoke import LOGITS_TOL, batch_inputs
    from scalellm_tpu_torch.ops import quant_matmul as Q

    name, _, quantize = model_name.partition("_int")
    model = _random_model(cuda, TINY_CFGS[name], quantize="int4" if quantize else "")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, n).tolist() for n in (150, 61)]
    prefill, n_pages = batch_inputs(torch, [(p, 0, len(p) + 1) for p in prompts])
    decode, _ = batch_inputs(torch, [([7 + i], len(p), len(p) + 1) for i, p in enumerate(prompts)])
    k1 = attention.ragged_paged_attention_cuda
    counters = (k1, getattr(k1, LAYERNORM_KINDS[name]), Q.quant_matmul_w4a8_cuda, Q.quant_matmul_dequant_cuda)
    logits = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain"):
            plain = impl == "plain"
            before = [c.launches for c in counters]
            model.attn_impl = attention.plain_ragged_paged_attention if plain else attention.ragged_paged_attention
            model.quant_impl = Q.plain_quant_matmul if plain else Q.quant_matmul
            kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=cuda)
            a = model.logits(model(kv, prefill.to(cuda), all_hidden=True)[: sum(map(len, prompts))])
            b = model.logits(model(kv, decode.to(cuda), decode_only=True)[: len(prompts)])
            logits[impl] = (a, b)
            launched = [c.launches - n for c, n in zip(counters, before)]
            L = model.args.n_layers
            q = 4 * L if quantize else 0
            assert launched == ([0, 0, 0, 0] if plain else [2 * L, 2 * L, q, q])
    tol = F32_TOL if name == "gpt2" else LOGITS_TOL
    for got, want in zip(logits["kernel"], logits["plain"]):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= tol


def test_a_closed_engine_gives_its_memory_back(cuda, tmp_path):
    """Two engines in a row in one process, each sizing its KV cache from
    the card's free memory: the second gets as many blocks as the first,
    and after each close the caching allocator keeps no more than
    chip_smoke.CLOSED_SLACK_BYTES of freed memory (LLM.close empties it)."""
    import chip_smoke
    from scalellm_tpu_torch import LLM, SamplingParams

    cfg = dict(TINY_LLAMA_CFG, vocab_size=256, architectures=["LlamaForCausalLM"], tie_word_embeddings=False,
               bos_token_id=1, eos_token_id=2)
    chip_smoke.write_checkpoint(torch, str(tmp_path), cfg)
    blocks = []
    for _ in range(2):
        llm = LLM(str(tmp_path), devices="cuda", num_handling_threads=1)
        blocks.append(llm._handler.engine.block_manager.options.num_blocks)
        llm.generate(["the quick brown fox"], SamplingParams(max_tokens=4, temperature=0.0))
        llm.close()
        assert torch.cuda.memory_reserved() - torch.cuda.memory_allocated() <= chip_smoke.CLOSED_SLACK_BYTES
    assert blocks[1] >= 0.99 * blocks[0], blocks


# ---------------------------------------------------------------- int8 KV pages
#
# K1 (bf16 and f32 q) over int8 pages, and K9/K10 over int8 latent pages:
# each element read as (int8 -> f32) * scale, rounded to bf16 by the bf16
# kernels (the stock kernel's cast to q's type), kept in f32 by the f32
# kernel. The pages are N(0, 1) values quantized as the model writes them
# (round(x / scale), clamped to 127), so outputs keep the magnitudes of the
# bf16 tests. Held to the plain versions at the bf16 tolerances (the plain
# K1 keeps int8 * scale in f32: the bf16 rounding of a scaled element moves a
# score by about 4e-3 of its size) and the f32 kernel at F32_TOL. "unit": the
# way DecoderModel calls K1, scales of 1.0 with q pre-multiplied by k_scale
# and the output by v_scale.

# (q_lens, kv_lens, S, T, n_heads, n_kv_heads, head_dim, window, soft_cap, page, ALiBi)
INT8_CASES = {
    "decode_d64_gqa8": ([1] * 8, [17, 64, 129, 256, 400, 640, 900, 1024], 8, 16, 32, 4, 64, None, None, 16, False),
    "mixed_d64_softcap": ([100, 37, 1, 1], [100, 300, 700, 2048], 4, 256, 32, 4, 64, None, 30.0, 16, False),
    "decode_d80_phi2": ([1] * 4, [5000, 100, 640, 33], 4, 16, 32, 32, 80, None, None, 16, False),
    "mixed_d80_window": ([60, 9, 1], [60, 200, 900], 4, 128, 16, 8, 80, 64, None, 16, False),
    "decode_d128_gqa4": ([1] * 8, [17, 64, 129, 256, 400, 640, 900, 1024], 8, 16, 32, 8, 128, None, None, 16, False),
    "mixed_d128_alibi": ([120, 60, 1, 1], [120, 300, 500, 17], 4, 256, 32, 32, 128, None, None, 16, True),
    "decode_d128_alibi_window": ([1] * 4, [3000, 129, 4000, 7], 4, 4, 12, 12, 128, 128, None, 16, True),
    "decode_d256_softcap": ([1] * 6, [17, 300, 1024, 2048, 4096, 5], 8, 16, 16, 8, 256, None, 50.0, 16, False),
    "mixed_d256_window_page4": ([33, 5, 1], [40, 600, 77], 4, 64, 16, 1, 256, 16, None, 4, False),
    "mixed_d64_alibi_page4": ([33, 5, 1], [40, 600, 77], 4, 64, 12, 12, 64, None, None, 4, True),
}
from chip_smoke import KV_INT8_SCALES as INT8_SCALES  # noqa: E402
from chip_smoke import quantize_kv_pages  # noqa: E402


def _int8_case(device, case, dtype):
    q_lens, kv_lens, S, T, H, Hkv, D, window, cap, page, alibi = INT8_CASES[case]
    inputs, kw, _, n_real = _k1_case(device, (q_lens, kv_lens, S, T, H, Hkv, D, window, cap, page), dtype)
    inputs["kv_pages"] = quantize_kv_pages(torch, inputs["kv_pages"], *INT8_SCALES)
    if alibi:
        from scalellm_tpu_torch.layers.alibi import alibi_slopes

        kw["alibi_slopes"] = torch.tensor(alibi_slopes(H), dtype=torch.float32, device=device)
    return inputs, kw, n_real


@pytest.mark.parametrize("scaled", ["scales", "unit"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_pages_match_plain_version(cuda, case, dtype, scaled):
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention_cuda as kernel
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    f32 = dtype == "f32"
    inputs, kw, n_real = _int8_case(cuda, case, torch.float32 if f32 else torch.bfloat16)
    ks, vs = INT8_SCALES
    if scaled == "scales":
        kw.update(k_scale=ks, v_scale=vs)
        post = 1.0
    else:  # DecoderModel's call: q * k_scale in q's type, scales of 1.0, the output * v_scale
        inputs["q"] = (inputs["q"].float() * ks).to(inputs["q"].dtype)
        kw.update(k_scale=1.0, v_scale=1.0)
        post = vs
    before = (kernel.launches, kernel.int8.launches, kernel.f32.launches)
    got = ragged_paged_attention(**inputs, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.int8.launches, kernel.f32.launches) == (
        before[0] + 1, before[1] + 1, before[2] + f32)
    want = ref_ragged_paged_attention(**inputs, **kw)
    got, want = (got.float() * post).to(got.dtype), (want.float() * post).to(want.dtype)
    if f32:
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=0)
        assert torch.all(got[n_real:] == 0)
    else:
        _assert_matches_plain(got, want, n_real)


@pytest.mark.parametrize("case", ["decode_d64_gqa8", "decode_d128_alibi_window", "decode_d256_softcap"])
def test_int8_pages_pass_the_row_check_that_fails_a_lost_piece(cuda, case):
    """K1 on int8 decode batches within ATTENTION_REL_TOL of each row's size,
    as its plain split-and-merge is; with the longest slot's middle piece
    left out that split-and-merge fails the check. The same bits on every
    call."""
    from scalellm_tpu_torch.ops.attention import plain_split_kv_attention, ragged_paged_attention_cuda
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    q_lens, kv_lens, S, T, H, Hkv, D, window, cap, page, alibi = INT8_CASES[case]
    inputs, kw, n_real = _int8_case(cuda, case, torch.bfloat16)
    kw.update(k_scale=INT8_SCALES[0], v_scale=INT8_SCALES[1])
    got = ragged_paged_attention_cuda(**inputs, **kw)
    torch.cuda.synchronize()
    want = ref_ragged_paged_attention(**inputs, **kw)
    _assert_matches_plain(got, want, n_real)
    assert attention_row_rel_err(torch, plain_split_kv_attention(**inputs, **kw), want) <= ATTENTION_REL_TOL
    spec = dict(S=S, Hkv=Hkv, kv_lens=kv_lens, window=window)
    lost = plain_split_kv_attention(**inputs, **kw, drop=dropped_piece(attention, spec, inputs))
    assert attention_row_rel_err(torch, lost, want) > ATTENTION_REL_TOL
    for _ in range(5):
        assert torch.equal(ragged_paged_attention_cuda(**inputs, **kw), got)


def test_int8_pages_refuse_what_the_kernels_do_not_cover(cuda):
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention
    from scalellm_tpu_torch.ops import mla_attention as M

    inputs, kw, _ = _int8_case(cuda, "decode_d64_gqa8", torch.bfloat16)
    with pytest.raises(NotImplementedError):  # half q over int8 pages
        ragged_paged_attention(**{**inputs, "q": inputs["q"].half()}, k_scale=0.1, v_scale=0.1)
    with pytest.raises(NotImplementedError):  # uint8 pages
        ragged_paged_attention(**{**inputs, "kv_pages": inputs["kv_pages"].view(torch.uint8)}, k_scale=0.1)
    mla = _mla_case(cuda, "decode_padding_slots")
    mla["k_pages"] = torch.round(mla["k_pages"].float() * 16).clamp(-127, 127).to(torch.int8)
    with pytest.raises(NotImplementedError):  # f32 q over int8 latent pages
        M.mla_paged_attention(**{**mla, "q": mla["q"].float()}, sm_scale=0.1, v_dim=512, k_scale=0.0625,
                              decode_only=True)


# (MLA case, k_scale): DeepSeek's default 1/16 (int8 * scale exact in bf16),
# and a scale whose products round.
MLA_INT8_CASES = [("decode_v2_lite", 0.0625), ("mixed_v2_lite", 0.0625), ("decode_8192", 0.0625),
                  ("decode_h128", 0.021), ("mixed_odd_chunks", 0.021), ("decode_splits_past_kv_len", 0.021)]


@pytest.mark.parametrize("case,k_scale", MLA_INT8_CASES)
def test_mla_kernels_over_int8_pages_match_plain_versions(cuda, case, k_scale):
    """K9/K10 over int8 latent pages through the dispatcher against the
    plain versions (which widen as the kernels do): within TOL and row by
    row within ATTENTION_REL_TOL; padding rows zero; the same bits on a
    second call; the split decodes' row check fails a lost piece."""
    from scalellm_tpu_torch.ops import mla_attention as M

    q_lens, kv_lens, S, T, H, Dc, vd = MLA_CASES[case]
    inputs = _mla_case(cuda, case)
    inputs["k_pages"] = torch.round(inputs["k_pages"].float() / k_scale).clamp(-127, 127).to(torch.int8)
    decode_only = all(n == 1 for n in q_lens)
    kw = dict(sm_scale=0.0723, v_dim=vd, k_scale=k_scale, decode_only=decode_only)
    kernel = M.mla_decode_attention_cuda if decode_only else M.mla_prefill_attention_cuda
    before = (kernel.launches, kernel.int8.launches)
    got = M.mla_paged_attention(**inputs, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.int8.launches) == (before[0] + 1, before[1] + 1)
    want = M.plain_mla_paged_attention(**inputs, **kw)
    assert got.shape == (T, H, vd)
    _assert_matches_plain(got, want, len(q_lens) if decode_only else sum(q_lens))
    assert torch.equal(M.mla_paged_attention(**inputs, **kw), got)
    if decode_only and case in MLA_SPLIT_CASES:
        args = (inputs["q"], inputs["k_pages"], inputs["kv_lens"], inputs["page_indices"])
        capacity = inputs["page_indices"].shape[1] * inputs["k_pages"].shape[1]
        _, split_len = M.mla_split_plan(capacity, S, -(-H // M.HEAD_GROUP),
                                        torch.cuda.get_device_properties(cuda).multi_processor_count)
        s = max(range(len(kv_lens)), key=lambda i: kv_lens[i])
        lost = M.plain_mla_split_decode(*args, sm_scale=0.0723, v_dim=vd, k_scale=k_scale,
                                        drop=(s, (kv_lens[s] - 1) // split_len // 2))
        assert attention_row_rel_err(torch, lost, want) > ATTENTION_REL_TOL


def _random_int8_kv_model(device, cfg):
    """_random_model with kv_cache_dtype="int8" and per-layer scales near
    what calibration gives these weights."""
    import scalellm_tpu_torch.models  # noqa: F401  (registers the models)
    from scalellm_tpu_torch.models.registry import ModelRegistry

    args = ModelRegistry.get_model_args_loader(cfg["model_type"])(dict(cfg))
    args.kv_cache_dtype = "int8"
    model = ModelRegistry.get_causal_lm_factory(cfg["model_type"])(args, device=device)
    g = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.05, generator=g)
        if hasattr(model, "kv_scales"):
            model.kv_scales.uniform_(0.01, 0.03, generator=g)
    return model


@pytest.mark.parametrize("model_name", ["llama", "mpt", "gpt2", "deepseek"])
def test_executor_with_graphs_over_int8_pages_gives_the_eager_bits(cuda, model_name):
    """An int8-KV model through Executor with step graphs and eagerly: the
    same tokens and logits bits, over an int8 cache; K1's (K9/K10's) int8
    launches counted at the captures."""
    from chip_smoke import batch_inputs
    from scalellm_tpu_torch.engine.executor import Executor
    from scalellm_tpu_torch.ops import mla_attention as M

    model = _random_int8_kv_model(cuda, TINY_CFGS[model_name])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, n).tolist() for n in (60, 37, 100)]
    steps = [(batch_inputs(torch, [(p, 0, len(p) + 8) for p in prompts])[0], False)]
    for i in range(3):
        steps.append((batch_inputs(torch, [([int(rng.integers(1, 512))], len(p) + i, len(p) + 8)
                                           for p in prompts])[0], True))
    int8_counts = (attention.ragged_paged_attention_cuda.int8, M.mla_decode_attention_cuda.int8,
                   M.mla_prefill_attention_cuda.int8)
    runs = {}
    for graphs in (True, False):
        before = sum(c.launches for c in int8_counts)
        ex = Executor(model, cuda)
        ex.init_kv_cache(64, 16)
        assert ex.kv_cache.dtype == torch.int8
        eager_logits, forward = [], ex._forward
        if graphs:
            ex.init_graphs(16, max_tokens=256, max_seqs=4, max_context_len=1024)
        else:
            ex._forward = lambda mi, d: eager_logits.append(forward(mi, d)) or eager_logits[-1]
        tokens, logits = [], []
        for mi, decode_only in steps:
            out = ex.execute(mi, _greedy_si(mi.kv_lens.shape[0]), decode_only=decode_only)
            tokens.append(out.next_tokens.cpu())
            logits.append((ex.graphs.graphs[ex.graphs.last_key].logits if graphs else eager_logits[-1]).cpu())
        assert sum(c.launches for c in int8_counts) > before
        runs[graphs] = tokens, logits
    for got, want in zip(runs[True], runs[False]):
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


# ---------------------------------------------------------------- KV swap
#
# Executor.fetch_pages_async / restore_pages on the card: the page round trip
# in place, a replayed step graph reading restored pages, and a fetch ordered
# before a later step that overwrites the pages it gathers.


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_pages_restored_into_other_blocks_are_the_pages_fetched(cuda, kv_cache_dtype):
    from scalellm_tpu_torch.engine.executor import Executor

    model = (_random_int8_kv_model if kv_cache_dtype == "int8" else _random_model)(cuda, TINY_LLAMA_CFG)
    ex = Executor(model, cuda)
    ex.init_kv_cache(32, 16)
    ptr = ex.kv_cache.data_ptr()
    g = torch.Generator(device=cuda).manual_seed(0)
    if ex.kv_cache.dtype == torch.int8:
        ex.kv_cache.copy_(torch.randint(-127, 128, ex.kv_cache.shape, generator=g, device=cuda, dtype=torch.int8))
    else:
        ex.kv_cache.normal_(generator=g)
    ids = np.asarray([3, 7, 8, 20], np.int32)
    first = ex.fetch_pages(ids)
    assert first.is_pinned() and first.device.type == "cpu"
    ex.restore_pages(np.asarray([25, 26, 27, 28], np.int32), first)
    again = ex.fetch_pages(np.asarray([25, 26, 27, 28], np.int32))
    assert torch.equal(_bits(again), _bits(first))
    assert torch.equal(_bits(ex.kv_cache[:, 25:29].cpu()), _bits(ex.kv_cache[:, ids].cpu()))
    assert ex.kv_cache.data_ptr() == ptr


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_a_replayed_graph_reads_restored_pages(cuda, kv_cache_dtype):
    """A sequence prefilled into blocks 1-8, its decode step captured and
    replayed; then its pages are fetched, the blocks wiped, the pages
    restored into blocks 20-27 and the same decode step replayed over the
    new block table: the same logits bits (the graph reads the cache in
    place)."""
    from chip_smoke import batch_inputs
    from scalellm_tpu_torch.engine.executor import Executor

    model = (_random_int8_kv_model if kv_cache_dtype == "int8" else _random_model)(cuda, TINY_LLAMA_CFG)
    ex = Executor(model, cuda)
    ex.init_kv_cache(32, 16)
    ex.init_graphs(16, max_tokens=256, max_seqs=1, max_context_len=1024)
    ptr = ex.kv_cache.data_ptr()
    prompt = np.random.default_rng(0).integers(1, 512, 120).tolist()
    prefill, _ = batch_inputs(torch, [(prompt, 0, 128)])  # blocks 1-8
    ex.execute(prefill, _greedy_si(1))

    def decode(first_block):
        mi, _ = batch_inputs(torch, [([5], 120, 128)])
        tables = mi.block_tables.clone()
        tables[0, :8] = torch.arange(first_block, first_block + 8, dtype=torch.int32)
        mi.block_tables = tables
        mi.new_kv_slot_ids = (tables[0, 120 // 16] * 16 + 120 % 16).reshape(1).expand_as(mi.new_kv_slot_ids).clone()
        mi.new_kv_slot_ids[1:] = 0
        ex.execute(mi, _greedy_si(1), decode_only=True)
        return ex.graphs.graphs[ex.graphs.last_key].logits.clone()

    want = decode(1)
    staged = ex.fetch_pages(np.arange(1, 9, dtype=np.int32))
    ex.kv_cache[:, 1:9].zero_()
    ex.restore_pages(np.arange(20, 28, dtype=np.int32), staged)
    replays = sum(ex.graphs.replays.values())
    got = decode(20)
    assert sum(ex.graphs.replays.values()) == replays + 1 and len(ex.graphs.graphs) == 2
    assert ex.kv_cache.data_ptr() == ptr
    assert torch.equal(_bits(got), _bits(want))


def test_fetch_is_ordered_before_a_step_that_overwrites_its_pages(cuda):
    """fetch_pages_async on pages behind a device spin, then a step that
    writes new KV into the same pages, enqueued before the fetch is waited
    on: the fetch returns the pages as they were before that step."""
    from chip_smoke import batch_inputs
    from scalellm_tpu_torch.engine.executor import Executor

    ex = Executor(_random_model(cuda, TINY_LLAMA_CFG), cuda)
    ex.init_kv_cache(32, 16)
    g = torch.Generator(device=cuda).manual_seed(1)
    ex.kv_cache.normal_(generator=g)
    ids = np.arange(1, 9, dtype=np.int32)
    before = ex.kv_cache[:, 1:9].cpu()
    torch.cuda._sleep(2**28)  # the gather waits behind a spin
    pending = ex.fetch_pages_async(ids)
    prompt = np.random.default_rng(2).integers(1, 512, 120).tolist()
    prefill, _ = batch_inputs(torch, [(prompt, 0, 128)])  # writes blocks 1-8
    ex.execute(prefill, _greedy_si(1))
    staged = pending.wait()
    torch.cuda.synchronize()
    assert torch.equal(_bits(staged), _bits(before))
    assert not torch.equal(_bits(ex.kv_cache[:, 1:9].cpu()), _bits(before))  # the step did overwrite them


# Speculative decoding on the card: the rejection sampler's draws follow the
# target distribution on the device; a round's graph (k draft steps, the
# target's verify forward over k+1 tokens a sequence, the sampler) captured
# once and replayed at other KV lengths and block tables gives the eager
# round's ids and KV bits, with K1 launched k times a draft layer and once a
# target layer at its capture.


@pytest.mark.parametrize("onehot", [False, True])
def test_rejection_sampler_draws_follow_the_target_on_the_device(cuda, onehot):
    from scipy.stats import chisquare

    from scalellm_tpu_torch.speculative.rejection_sampler import rejection_sample, rejection_sample_onehot

    S, k, V = 40000, 2, 6
    p = torch.tensor([0.3, 0.25, 0.2, 0.15, 0.07, 0.03], device=cuda)
    q = torch.tensor([0.05, 0.1, 0.15, 0.2, 0.25, 0.25], device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    target = p.expand(S, k + 1, V).contiguous()
    draft_ids = (torch.full((S, k), 4, dtype=torch.int32, device=cuda) if onehot
                 else torch.multinomial(q.expand(S * k, V), 1, generator=g).view(S, k).int())
    seeds = torch.randint(0, 2**32, (S,), dtype=torch.int64, device=cuda, generator=g)
    do_sample = torch.ones(S, dtype=torch.bool, device=cuda)
    if onehot:
        out = rejection_sample_onehot(draft_ids, target, do_sample, seeds)
    else:
        out = rejection_sample(draft_ids, q.expand(S, k, V).contiguous(), target, do_sample, seeds)
    counts = torch.bincount(out[:, 0].long(), minlength=V).cpu().numpy()
    expected = p.double().cpu().numpy()
    assert chisquare(counts, S * expected / expected.sum()).pvalue > 1e-3
    # Greedy rows: the target's argmax wherever the draft is not it.
    out = rejection_sample_onehot(torch.where(draft_ids == 0, 1, draft_ids), target, ~do_sample, seeds)
    assert (out[:, 0] == 0).all() and (out[:, 1:] == -1).all()


def _round_arrays(prompts, off, k, cap, sampled, seed0):
    """A round's host arrays over the prompts' pages as chip_smoke's
    batch_inputs hands them out (from page 1, `cap` tokens a sequence), its
    first token at position len(prompt) + off."""
    from scalellm_tpu_torch.engine.batch import PAGE_BUCKETS, SEQ_BUCKETS, pick_bucket

    rng = np.random.default_rng(seed0)
    S, MAXP, n = pick_bucket(SEQ_BUCKETS, len(prompts)), pick_bucket(PAGE_BUCKETS, -(-cap // 16)), len(prompts)
    a = dict(first_tokens=np.zeros(S, np.int32), positions0=np.zeros(S, np.int32),
             slot_ids=np.zeros((S, k + 1), np.int32), block_tables=np.zeros((S, MAXP), np.int32),
             seq_mask=(np.arange(S) < n).astype(np.float32), num_seqs=np.array([n], np.int32),
             temperatures=np.zeros(S, np.float32), top_ks=np.zeros(S, np.int32), top_ps=np.ones(S, np.float32),
             seeds=rng.integers(0, 2**32, S, dtype=np.uint64).astype(np.uint32),
             draft_ids=np.zeros((S, k), np.int32))
    for s, p in enumerate(prompts):
        pages = np.arange(1 + s * (-(-cap // 16)), 1 + (s + 1) * (-(-cap // 16)), dtype=np.int32)
        pos = len(p) + off + np.arange(k + 1)
        a["first_tokens"][s] = rng.integers(1, 512)
        a["positions0"][s] = pos[0]
        a["slot_ids"][s] = pages[pos // 16] * 16 + pos % 16
        a["block_tables"][s, : len(pages)] = pages
        a["draft_ids"][s] = rng.integers(1, 512, k)
        if sampled:
            a["temperatures"][s] = (0.8, 0.0, 1.0)[s % 3]
            a["top_ps"][s] = 0.9 if s == 2 else 1.0
    return a, S, MAXP


@pytest.mark.parametrize("kind", ["draft_greedy", "draft_sampled", "ngram_sampled"])
def test_round_graph_replayed_at_other_kv_lens_gives_the_eager_round(cuda, kind):
    from chip_smoke import batch_inputs
    from scalellm_tpu_torch.engine.executor import Executor
    from scalellm_tpu_torch.speculative.ngram import NgramSpecExecutor
    from scalellm_tpu_torch.speculative.spec_executor import SpecExecutor

    k, cap = 4, 96
    target = _random_model(cuda, TINY_LLAMA_CFG)
    draft = _random_model(cuda, dict(TINY_LLAMA_CFG, hidden_size=256, intermediate_size=512,
                                     num_attention_heads=4, num_key_value_heads=1))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (30, 17, 50)]
    prefill = batch_inputs(torch, [(p, 0, cap) for p in prompts])[0]
    rounds = [_round_arrays(prompts, off, k, cap, kind.endswith("sampled"), 10 + off) for off in (0, 9, 23)]
    runs = {}
    for graphs in (True, False):
        ex_t, ex_d = Executor(target, cuda), Executor(draft, cuda)
        for ex in (ex_t, ex_d):
            ex.init_kv_cache(32, 16)
            ex.execute(prefill, _greedy_si(4))
        if graphs:
            ex_t.init_graphs(16, max_tokens=128, max_seqs=4, max_context_len=1024)
        spec = NgramSpecExecutor(ex_t, k) if kind.startswith("ngram") else SpecExecutor(ex_t, ex_d, k)
        outs, launches = [], []
        for arrays, S, MAXP in rounds:
            before = attention.ragged_paged_attention_cuda.launches
            outs.append(spec.run(arrays, S, MAXP))
            launches.append(attention.ragged_paged_attention_cuda.launches - before)
        torch.cuda.synchronize()
        if graphs:
            assert len(ex_t.graphs.graphs) == 1 and sum(ex_t.graphs.replays.values()) == 3
            per_round = 2 if kind.startswith("ngram") else k * 2 + 2  # 2 draft and 2 target layers
            assert launches == [2 * per_round, 0, 0]  # the capture's eager run and its recording
        runs[graphs] = outs, ex_t.kv_cache.clone(), ex_d.kv_cache.clone()
    (got, kv_t, kv_d), (want, kv_te, kv_de) = runs[True], runs[False]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert ((a[:3, : k + 1] >= 0).sum(1) >= 1).all()  # every row keeps a token
    assert torch.equal(_bits(kv_t[:, 1:]), _bits(kv_te[:, 1:])) and torch.equal(_bits(kv_d[:, 1:]), _bits(kv_de[:, 1:]))


# Multi-LoRA: an engine with two random adapters (chip_smoke's, in the HF
# PEFT layout) serves a batch that mixes the base and both adapters with
# graphs and eagerly, the same ids; a prefill and a decode batch with all
# three slots through the kernels (K1; INT4: K2/K4 without the RMSNorm
# prologue) and the plain versions, within chip_smoke.LOGITS_TOL, the
# adapter moving the logits from the base's.


@pytest.mark.parametrize("quantize", ["", "int4"])
def test_lora_engine_with_graphs_gives_the_eager_ids(cuda, quantize, tmp_path):
    import chip_smoke
    from scalellm_tpu_torch import LLM, SamplingParams

    cfg = dict(TINY_LLAMA_CFG, vocab_size=256, architectures=["LlamaForCausalLM"], tie_word_embeddings=False,
               bos_token_id=1, eos_token_id=2)
    chip_smoke.write_checkpoint(torch, str(tmp_path), cfg)
    adapters, _, _ = chip_smoke.write_lora_adapters(torch, str(tmp_path / "adapters"), cfg)
    prompts = ["the quick brown fox", "paged attention kernel", "abc", "decode and prefill " * 3]
    loras = [None, "one", "two", "one"]
    sp = SamplingParams(max_tokens=13, temperature=0.0, ignore_eos=True)
    got = {}
    for graphs in (True, False):
        with LLM(str(tmp_path), devices="cuda", num_blocks=64, num_handling_threads=1, quantize=quantize,
                 enable_cuda_graph=graphs, enable_async_scheduling=False, lora_modules=adapters) as llm:
            outs = llm.generate(prompts, sp, lora=loras)
            assert all(o.status.ok and o.usage.num_generated_tokens == 13 for o in outs)
            got[graphs] = [o.outputs[0].token_ids for o in outs]
    assert got[True] == got[False]


@pytest.mark.parametrize("quantize", ["", "int4"])
def test_lora_kernel_path_matches_plain_versions(cuda, quantize):
    import chip_smoke
    from scalellm_tpu_torch.lora import LoraMeta

    model = _random_model(cuda, TINY_LLAMA_CFG, quantize=quantize)
    L = model.args.n_layers
    dims = chip_smoke.lora_dims(TINY_LLAMA_CFG)
    meta = LoraMeta(names=["one", "two"], targets=tuple(sorted(dims)), n_slots=3, r_max=8)
    g = torch.Generator().manual_seed(5)
    stacks = {}
    for t, (K, N) in dims.items():
        A, B = torch.randn(L, 3, K, 8, generator=g) * 0.05, torch.randn(L, 3, 8, N, generator=g) * 0.05
        A[:, 0] = 0
        B[:, 0] = 0
        stacks[f"lora_{t}"] = (A, B)
    model.set_lora(meta, stacks)
    assert model._fused_norm(model.layers[0], "qkv_proj", model.layers[0].input_norm) is None
    rng = np.random.default_rng(6)
    ids = [rng.integers(1, 512, n).tolist() for n in (150, 61, 9)]
    moved = chip_smoke.lora_kernel_check(torch, {"nvidia_smi": ""}, f"test_lora{quantize}", model, ids, [0, 1, 2],
                                         quant=bool(quantize))
    assert moved > chip_smoke.LORA_MOVE_MIN


# Guided decoding: the allowed-mask stage on the card (the mask rides to the
# card as int64 words, SamplingInputs.to) gives the CPU's masked logits bit
# for bit at TinyLlama's and Llama-3's vocabularies, and the greedy ids under
# the mask; a guided serve with graphs gives the eager serve's ids (the
# sampler, mask included, runs eagerly after each replay).


@pytest.mark.parametrize("V", [32000, 128256])
def test_allowed_mask_on_the_card_gives_the_cpu_bits(cuda, V):
    import dataclasses

    from scalellm_tpu_torch.constrained.tokenmap import pack_bool_mask
    from scalellm_tpu_torch.engine.executor import minimal_sampling_inputs
    from scalellm_tpu_torch.sampling.sampler import SamplingPlan, apply_allowed_mask, sample_tokens

    rng = np.random.default_rng(V)
    S, W = 8, -(-V // 32)
    logits = torch.from_numpy((rng.standard_normal((S, V)) * 4).astype(np.float32))
    # Rows: half the ids, 1%, every id, one id (the last), none past V's
    # last word, a word boundary's ids, 20 ids, all but the first.
    rows = [rng.random(V) < 0.5, rng.random(V) < 0.01, np.ones(V, bool), np.arange(V) == V - 1,
            np.arange(V) < V - 7, (np.arange(V) % 32) == 31, np.isin(np.arange(V), rng.choice(V, 20)),
            np.arange(V) > 0]
    packed = np.stack([pack_bool_mask(r) for r in rows])
    assert packed.shape == (S, W) and packed.dtype == np.uint32
    si = dataclasses.replace(minimal_sampling_inputs(S), allowed_mask=packed)
    want = apply_allowed_mask(logits, si.to("cpu").allowed_mask)
    got = apply_allowed_mask(logits.to(cuda), si.to(cuda).allowed_mask)
    assert si.to(cuda).allowed_mask.dtype == torch.int64
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(want > -1e29, torch.from_numpy(np.stack(rows)))
    plan = SamplingPlan.of(si)
    assert plan.allowed_mask
    g = sample_tokens(logits.to(cuda), si.to(cuda), plan=plan).next_tokens.cpu()
    w = sample_tokens(logits, si.to("cpu"), plan=plan).next_tokens
    assert torch.equal(g, w)
    assert all(rows[s][int(w[s])] for s in range(S))


def test_guided_serve_with_graphs_gives_the_eager_ids(cuda, tmp_path):
    import json

    import chip_smoke
    from scalellm_tpu_torch import LLM, SamplingParams
    from scalellm_tpu_torch.utils.tools import guided_regex_for_tools

    cfg = dict(TINY_LLAMA_CFG, vocab_size=2048, architectures=["LlamaForCausalLM"], tie_word_embeddings=False,
               bos_token_id=1, eos_token_id=2)
    chip_smoke.write_checkpoint(torch, str(tmp_path), cfg)
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(chip_smoke.guided_tokenizer_json(cfg["vocab_size"]), f)
    guides = {"choice": dict(guided_choice=chip_smoke.GUIDED_CHOICES), "regex": dict(guided_regex=chip_smoke.GUIDED_PHONE),
              "schema": dict(guided_json=chip_smoke.GUIDED_SCHEMA),
              "tool": dict(guided_regex=guided_regex_for_tools([chip_smoke.GUIDED_TOOL])), "free": {}}
    prompts = ["the quick brown fox", "paged attention kernel", "abc", chip_smoke.tool_prompt("weather?"), "decode"]
    sps = [SamplingParams(max_tokens=64, temperature=0.0, **g) for g in guides.values()]
    got = {}
    for graphs in (True, False):
        with LLM(str(tmp_path), devices="cuda", num_blocks=128, num_handling_threads=1, enable_cuda_graph=graphs,
                 enable_async_scheduling=False) as llm:
            outs = llm.generate(prompts, sps)
            assert all(o.status.ok and o.finished for o in outs)
            got[graphs] = [(o.outputs[0].token_ids, o.outputs[0].text, o.outputs[0].finish_reason.name) for o in outs]
    assert got[True] == got[False]
    for name, (_, text, reason) in zip(guides, got[True]):
        if name in ("choice", "regex", "tool"):  # bounded languages end within max_tokens
            assert reason == "STOP" and chip_smoke.guided_valid(name, text), (name, text)
