"""The port's plain ragged paged attention and KV scatter against the JAX
package's (scalellm_tpu/ops/attention_ref.py, ops/kv_update.py), on random
ragged mixed prefill/decode batches in float32. Tolerance 1e-5: both sum
the same f32 products, in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.ops.attention_ref import ref_ragged_paged_attention as jax_ref
from scalellm_tpu.ops.kv_update import set_kv_cache as jax_set_kv_cache
from scalellm_tpu_torch.ops.attention import (
    ragged_paged_attention,
    ragged_paged_attention_cuda,
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
