"""The port's plain ragged paged attention and KV scatter against the JAX
package's (scalellm_tpu/ops/attention_ref.py, ops/kv_update.py), on random
ragged mixed prefill/decode batches in float32. Tolerance 1e-5: both sum
the same f32 products, in another order. The plain split-and-merge of the
kernel's decode path (plain_split_kv_attention) is held to both references
at the same tolerance: its pieces rescale by exp(m_i - M), f32 roundings of
the same sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.ops.attention_ref import ref_ragged_paged_attention as jax_ref
from scalellm_tpu.ops.kv_update import set_kv_cache as jax_set_kv_cache
from scalellm_tpu_torch.ops.attention import (
    KV_STAGE,
    MAX_SPLIT_LEN,
    plain_ragged_paged_attention,
    plain_split_kv_attention,
    ragged_paged_attention,
    ragged_paged_attention_cuda,
    split_kv_plan,
)
from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention
from scalellm_tpu_torch.ops.kv_update import set_kv_cache
from tests.torch_port_util import ragged_batch

TOL = 1e-5

# (n_heads, n_kv_heads, head_dim, sliding_window, soft_cap)
CASES = {
    "gqa8_d64": (8, 1, 64, None, None),
    "gqa2_d64": (4, 2, 64, None, None),
    "gqa8_d128": (8, 1, 128, None, None),
    "gqa2_d128": (4, 2, 128, None, None),
    "window": (4, 2, 64, 5, None),
    "softcap": (4, 2, 64, None, 5.0),
    "window_softcap_d128": (8, 2, 128, 3, 30.0),
}


def _both(inputs, **kw):
    args = [inputs[k] for k in ("q", "kv_pages", "kv_lens", "page_indices",
                                "cu_q_lens", "num_seqs")]
    want = np.asarray(jax_ref(*[jnp.asarray(a) for a in args], **kw))
    targs = [torch.from_numpy(a) for a in args]
    if "alibi_slopes" in kw:
        kw = dict(kw, alibi_slopes=torch.from_numpy(np.asarray(kw["alibi_slopes"])))
    got = ref_ragged_paged_attention(*targs, **kw).numpy()
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_plain_attention_matches_jax(case):
    H, Hkv, D, window, cap = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    # Two prefill chunks (one the tail of a longer context), three decodes,
    # three padding sequences and bucket-padding token rows.
    inputs = ragged_batch(
        rng, q_lens=[6, 4, 1, 1, 1], kv_lens=[6, 11, 9, 1, 14], S=8, T=16,
        n_heads=H, n_kv_heads=Hkv, head_dim=D,
    )
    got, want = _both(inputs, sm_scale=D ** -0.5, sliding_window=window,
                      logit_soft_cap=cap)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert np.all(got[13:] == 0.0)  # padding rows: zeros, not NaN


@pytest.mark.parametrize("extra", ["kv_scales", "alibi"])
def test_plain_attention_scales_and_alibi_match_jax(extra):
    rng = np.random.default_rng(7)
    inputs = ragged_batch(rng, q_lens=[5, 1], kv_lens=[5, 7], S=4, T=8,
                          n_heads=4, n_kv_heads=2, head_dim=64)
    if extra == "kv_scales":
        kw = dict(k_scale=0.5, v_scale=0.25)
    else:
        kw = dict(alibi_slopes=np.array([0.5, 0.25, 0.125, 0.0625], np.float32))
    got, want = _both(inputs, sm_scale=0.125, **kw)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_rows_past_the_last_real_token_are_zero():
    """With no padding sequence slot, the JAX reference gives the bucket
    padding rows to the last sequence; the port writes zeros there, as the
    CUDA kernel does. The real rows still match."""
    rng = np.random.default_rng(3)
    inputs = ragged_batch(rng, q_lens=[3, 1], kv_lens=[3, 6], S=2, T=8,
                          n_heads=4, n_kv_heads=2, head_dim=64)
    got, want = _both(inputs, sm_scale=0.125)
    np.testing.assert_allclose(got[:4], want[:4], atol=TOL, rtol=TOL)
    assert np.all(got[4:] == 0.0)


def test_dispatcher_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    inputs = {k: torch.from_numpy(v) for k, v in ragged_batch(
        rng, q_lens=[2, 1], kv_lens=[4, 3], S=4, T=4, n_heads=4,
        n_kv_heads=2, head_dim=64).items()}
    before = ragged_paged_attention_cuda.launches
    out = ragged_paged_attention(**inputs, sm_scale=0.125)
    ref = ref_ragged_paged_attention(**inputs, sm_scale=0.125)
    assert torch.equal(out, ref)
    assert ragged_paged_attention_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(5)
    inputs = {k: torch.from_numpy(v) for k, v in ragged_batch(
        rng, q_lens=[1], kv_lens=[2], S=1, T=1, n_heads=4, n_kv_heads=2,
        head_dim=64).items()}
    with pytest.raises(ValueError):
        ragged_paged_attention_cuda(**inputs)


def test_ctypes_signature_matches_the_cuda_source():
    """The wrapper's ctypes argtypes follow the C entry point's parameter
    list in csrc/ragged_paged_attention.cu, so no argument is passed with
    another type or width."""
    import ctypes
    import pathlib
    import re

    from scalellm_tpu_torch.ops import attention

    src = (pathlib.Path(attention.__file__).parent.parent / "csrc"
           / "ragged_paged_attention.cu").read_text()
    params = re.search(
        r'extern "C" int scalellm_ragged_paged_attention\((.*?)\)\s*\{', src, re.S
    ).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    want = []
    for p in params.split(","):
        words = p.replace("*", " * ").split()[:-1]  # drop the parameter name
        want.append(kinds["void*" if "*" in words else words[-1]])
    assert attention._ARGTYPES == want


# Decode-only batches for the split path: (n_heads, n_kv_heads, head_dim,
# page, kv_lens, S, T, window, soft cap). At page 4 and these widths the
# plan cuts each slot into pieces of 64 rows: contexts of 1-300 rows give
# empty pieces past kv_len.
SPLIT_CASES = {
    "splits_d64": (8, 2, 64, 4, [300, 70, 5, 129], 4, 16, None, None),
    "window_mid_split": (4, 2, 64, 4, [250, 200, 64], 4, 4, 100, None),  # lo = 150, 101, 0
    "softcap_d128": (8, 1, 128, 16, [190, 33], 2, 16, None, 20.0),
    "padding_slots": (4, 2, 64, 4, [90, 12], 8, 16, None, None),  # 6 padding slots, 14 padding rows
    "window_softcap_before_window": (4, 4, 64, 4, [256, 9], 2, 2, 30, 10.0),  # pieces 0-2 before the window
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_plain_split_kv_matches_reference_and_jax(case):
    H, Hkv, D, page, kv_lens, S, T, window, cap = SPLIT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    inputs = ragged_batch(
        rng, q_lens=[1] * len(kv_lens), kv_lens=kv_lens, S=S, T=T, n_heads=H,
        n_kv_heads=Hkv, head_dim=D, page_size=page,
        num_pages=1 + sum(-(-k // page) for k in kv_lens),
    )
    maxp = inputs["page_indices"].shape[1]
    splits, split_len = split_kv_plan(maxp * page, S, Hkv)
    assert splits > 1  # the case exercises the merge
    kw = dict(sm_scale=D ** -0.5, sliding_window=window, logit_soft_cap=cap)
    _, want_jax = _both(inputs, **kw)
    targs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    want = ref_ragged_paged_attention(**targs, **kw).numpy()
    got = plain_split_kv_attention(**targs, **kw).numpy()
    n = len(kv_lens)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[:n], want_jax[:n], atol=TOL, rtol=TOL)
    assert np.all(got[n:] == 0.0)  # padding rows: zeros, not NaN



# Decode batches at phase 3a's widths, in bf16 as on the card: (n_heads,
# n_kv_heads, head_dim, page, kv_lens, S, window, block-table length).
LOST_PIECE_CASES = {
    "f_long_d128": (32, 8, 128, 16, [8192], 1, None, 1024),  # phase 3a (f): 32 pieces of 512
    "c_decode_d128": (32, 8, 128, 16, [17, 64, 129, 256, 400, 640, 900, 1024], 8, None, 64),
    "window_mid_split_d128": (32, 8, 128, 16, [6000, 2048, 77], 3, 700, 375),
    "page4_d64": (32, 4, 64, 4, [4096, 3000, 100], 3, None, 1024),
}


@pytest.mark.parametrize("case", list(LOST_PIECE_CASES))
def test_row_check_fails_a_merge_that_lost_a_piece(case):
    """chip_smoke.py's row check (each (token, head) row's error within
    ATTENTION_REL_TOL of the row's size) passes the plain split-and-merge
    and fails it with the longest slot's middle piece left out: what a
    kernel whose merge lost that piece would give. KERNEL_TOL alone is of
    the size of these rows."""
    from chip_smoke import ATTENTION_REL_TOL, KERNEL_TOL, attention_row_rel_err, dropped_piece
    from scalellm_tpu_torch.ops import attention

    H, Hkv, D, page, kv_lens, S, window, maxp = LOST_PIECE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    inputs = ragged_batch(
        rng, q_lens=[1] * len(kv_lens), kv_lens=kv_lens, S=S, T=len(kv_lens), n_heads=H,
        n_kv_heads=Hkv, head_dim=D, page_size=page,
        num_pages=1 + sum(-(-k // page) for k in kv_lens),
    )
    table = inputs["page_indices"]
    inputs["page_indices"] = np.pad(table, ((0, 0), (0, maxp - table.shape[1])))
    targs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    targs["q"], targs["kv_pages"] = targs["q"].bfloat16(), targs["kv_pages"].bfloat16()
    kw = dict(sm_scale=D ** -0.5, sliding_window=window)
    want = ref_ragged_paged_attention(**targs, **kw)
    good = plain_split_kv_attention(**targs, **kw)
    assert (good.float() - want.float()).abs().max() <= KERNEL_TOL
    assert attention_row_rel_err(torch, good, want) <= ATTENTION_REL_TOL
    drop = dropped_piece(attention, dict(kv_lens=kv_lens, S=S, Hkv=Hkv, window=window), targs)
    lost = plain_split_kv_attention(**targs, **kw, drop=drop)
    assert attention_row_rel_err(torch, lost, want) > ATTENTION_REL_TOL

def test_split_kv_plan_edges():
    n_sm = 132
    # Enough (slot, head) pairs to fill the card: split only to MAX_SPLIT_LEN.
    assert split_kv_plan(4096, 64, 8, n_sm) == (8, 512)
    assert split_kv_plan(1000, 2 * n_sm, 1, n_sm) == (2, 512)
    assert split_kv_plan(512, 2 * n_sm, 1, n_sm) == (1, 512)
    # A table shorter than one stage: one piece of one stage.
    assert split_kv_plan(16, 1, 1, n_sm) == (1, KV_STAGE)
    assert split_kv_plan(0, 1, 1, n_sm) == (1, KV_STAGE)
    # One long slot: as many pieces as the card wants, each whole stages.
    assert split_kv_plan(16384, 1, 8, n_sm) == (32, 512)
    # Few stages: never more pieces than stages.
    assert split_kv_plan(256, 1, 1, n_sm) == (4, 64)
    for capacity in (1, 63, 64, 65, 1000, 1024, 8192, 65536):
        for slots, heads in ((1, 1), (1, 8), (8, 4), (8, 8), (64, 8), (256, 32)):
            splits, split_len = split_kv_plan(capacity, slots, heads, n_sm)
            assert split_len % KV_STAGE == 0 and 0 < split_len <= MAX_SPLIT_LEN
            assert splits * split_len >= capacity  # the pieces cover the table
            assert (splits - 1) * split_len < max(capacity, 1)  # and no piece lies past it
            # About 2 blocks an SM at the table's length, or pieces of MAX_SPLIT_LEN.
            assert splits <= max(1, -(-2 * n_sm // (slots * heads)), -(-capacity // MAX_SPLIT_LEN))


@pytest.mark.parametrize("decode_only", [False, True])
def test_dispatcher_takes_decode_only_on_cpu(decode_only):
    """On the CPU decode_only changes nothing: the plain version, no launch."""
    rng = np.random.default_rng(8)
    inputs = {k: torch.from_numpy(v) for k, v in ragged_batch(
        rng, q_lens=[1, 1, 1], kv_lens=[9, 3, 14], S=4, T=8, n_heads=8,
        n_kv_heads=2, head_dim=64).items()}
    before = ragged_paged_attention_cuda.launches
    out = ragged_paged_attention(**inputs, sm_scale=0.125, decode_only=decode_only)
    assert torch.equal(out, ref_ragged_paged_attention(**inputs, sm_scale=0.125))
    assert torch.equal(out, plain_ragged_paged_attention(**inputs, sm_scale=0.125,
                                                         decode_only=not decode_only))
    assert ragged_paged_attention_cuda.launches == before


def test_decoder_model_passes_decode_only_to_its_hook():
    from scalellm_tpu_torch.config import ModelArgs
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.models.common import DecoderModel

    seen = []

    def hook(*args, decode_only, **kw):
        seen.append(decode_only)
        return plain_ragged_paged_attention(*args, decode_only=decode_only, **kw)

    args = ModelArgs(model_type="llama", dtype="float32", hidden_size=64, intermediate_size=128,
                     n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256,
                     max_position_embeddings=512)
    model = DecoderModel(args, attn_impl=hook)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    # Two sequences of one token at positions 2 and 4, pages 1-2 of 4 slots.
    mi = ModelInputs(
        token_ids=torch.tensor([5, 7, 0, 0], dtype=torch.int32),
        positions=torch.tensor([2, 4, 0, 0], dtype=torch.int32),
        token_seg=torch.tensor([0, 1, 0, 0], dtype=torch.int32),
        new_kv_slot_ids=torch.tensor([6, 12, 0, 0], dtype=torch.int32),
        block_tables=torch.tensor([[1, 0], [2, 3]], dtype=torch.int32),
        kv_lens=torch.tensor([3, 5], dtype=torch.int32),
        cu_q_lens=torch.tensor([0, 1, 2], dtype=torch.int32),
        num_seqs=torch.tensor([2], dtype=torch.int32),
        selected_idxes=torch.tensor([0, 1], dtype=torch.int32),
        seq_mask=torch.ones(2),
    )
    kv = torch.randn(model.kv_cache_shape(4, 4), generator=gen)
    with torch.inference_mode():
        a = model(kv.clone(), mi, decode_only=True)
        b = model(kv.clone(), mi)
    assert seen == [True, True, False, False]
    assert torch.equal(a, b)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_set_kv_cache_matches_jax(kv_dtype):
    rng = np.random.default_rng(11)
    P, page, Hkv, D, T = 6, 4, 2, 64, 7
    pages = rng.standard_normal((P, page, 2 * Hkv, D)).astype(np.float32)
    k = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    slots = rng.choice(np.arange(page, P * page), T, replace=False).astype(np.int32)
    scales = {}
    if kv_dtype == "int8":
        pages = np.zeros(pages.shape, np.int8)
        scales = dict(k_scale=0.02, v_scale=0.03)
    want = np.asarray(jax_set_kv_cache(
        jnp.asarray(pages), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots),
        **scales))
    tp = torch.from_numpy(pages.copy())
    out = set_kv_cache(tp, torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(slots), **scales)
    assert out.data_ptr() == tp.data_ptr()  # written in place
    np.testing.assert_array_equal(tp.numpy(), want)
