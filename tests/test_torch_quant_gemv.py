"""The small-M variants (gemv, w4a8g) and the weight-stream probe of
scalellm_tpu_torch/ops/quant_matmul.py against the JAX package's Pallas
kernels in interpret mode, on the CPU, from numpy-seeded inputs.

- plain_gemv / plain_w4a8g against quant_matmul(..., backend="tpu",
  interpret=True, variant=...), flat and tiled storage, with and without
  the RMSNorm prologue. Tolerances as in test_torch_quant_matmul.py: the
  integer products are exact on both sides and only the order of the f32
  sums differs (the port scales per span of K, the reference per group and
  then per k-block): 2e-5 of the output's largest magnitude; with the
  prologue a last-bit difference of rsqrt can move a bf16 activation by one
  step (and a quantized one by 1): 2e-3, at most 5% of the rows past 2e-5.
- plain_stream against the reference's probe, the layer-stacked path under
  QUANT_STREAM_ONLY=1: exactly equal (the same f32 operations in the same
  order, with the product and the addition after it fused as XLA fuses
  them).
- plan() against the reference dispatcher for the variants at the M and G
  edges (M = 64 / 65, G = 32 / 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.ops import quant_matmul as JQ
from scalellm_tpu_torch.ops import quant_matmul as TQ
from tests.test_torch_quant_matmul import _case as _weights
from tests.test_torch_quant_matmul import _reference_plan, _x

EPS = 1e-5


def _gamma(K):
    return np.random.default_rng(2).uniform(0.5, 1.5, K).astype(np.float32)


# (variant, M, K, N, G, bits, asym, rms, tile (0: flat), scales)
CASES = {
    "gemv_m1_g128_tiled": ("gemv", 1, 512, 256, 128, 4, False, False, 128, "bf16"),
    "gemv_m5_g32_asym_rms": ("gemv", 5, 512, 128, 32, 4, True, True, 0, "f32"),
    "gemv_m16_int8_asym_tiled": ("gemv", 16, 256, 128, 128, 8, True, False, 128, "bf16"),
    "gemv_m16_g32_int8_rms_tiled": ("gemv", 16, 512, 256, 32, 8, False, True, 256, "f32"),
    # The tensor-core kernel's function at the edges of its contract: int4
    # and int8, symmetric and asymmetric, G = 32 and 128, M = 1, 16, 64.
    "gemv_m64_g128_asym": ("gemv", 64, 512, 128, 128, 4, True, False, 0, "f32"),
    "gemv_m64_int8_g32_asym_tiled": ("gemv", 64, 256, 128, 32, 8, True, False, 128, "bf16"),
    "gemv_m1_int8_g128": ("gemv", 1, 256, 128, 128, 8, False, False, 0, "f32"),
    "gemv_m16_g32": ("gemv", 16, 256, 128, 32, 4, False, False, 128, "bf16"),
    "gemv_m1_int8_g32_asym": ("gemv", 1, 256, 128, 32, 8, True, False, 0, "bf16"),
    "w4a8g_m1_asym_tiled": ("w4a8g", 1, 512, 256, 128, 4, True, False, 128, "f32"),
    "w4a8g_m5_rms": ("w4a8g", 5, 1024, 128, 128, 4, False, True, 0, "bf16"),
    "w4a8g_m16_int8_tiled": ("w4a8g", 16, 512, 256, 128, 8, False, False, 128, "bf16"),
    "w4a8g_m16_g32_goes_to_dequant": ("w4a8g", 16, 256, 128, 32, 4, True, False, 128, "f32"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_small_m_variants_match_the_pallas_kernels(case):
    variant, M, K, N, G, bits, asym, rms, tile, scales = CASES[case]
    (qw, sc, zp), (t_qw, t_sc, t_zp) = _weights(K, N, G, bits, asym, scales)
    x = _x(M, K)
    gamma = _gamma(K) if rms else None
    j = (qw, sc, zp)
    if tile:
        j = tuple(JQ.tile_quant_layout(a, tile) for a in j)
    want = np.asarray(JQ.quant_matmul(
        jnp.asarray(x), jnp.asarray(j[0]), jnp.asarray(j[1]), jnp.asarray(j[2]) if asym else None,
        bits=bits, backend="tpu", interpret=True, symmetric=not asym, variant=variant,
        rms_gamma=None if gamma is None else jnp.asarray(gamma), rms_eps=EPS))[:, :N]
    got = TQ.quant_matmul(
        torch.from_numpy(x), t_qw, t_sc, t_zp, bits=bits, symmetric=not asym, variant=variant,
        rms_gamma=None if gamma is None else torch.from_numpy(gamma), rms_eps=EPS,
        tile_n=tile or 4096)  # flat on the JAX side: its block_n default
    assert got.dtype == torch.float32
    top = np.abs(want).max()
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= (2e-3 if rms else 2e-5) * top, (diff.max(), top)
    assert (diff.max(axis=1) > 2e-5 * top).mean() <= 0.05


def test_small_m_plain_versions_agree_with_the_float_reference():
    """gemv is the group variant's function and w4a8g the W4A8 one: gemv is
    the float reference on bf16 activations up to f32 order; w4a8g equals
    plain_w4a8 up to f32 order (same quantized activations)."""
    _, (qw, sc, zp) = _weights(1024, 192, 128, 4, True, "f32")
    x = torch.from_numpy(_x(9, 1024)).to(torch.bfloat16)
    ref = TQ.ref_quant_matmul(x.float(), qw, sc, zp, 4)
    got = TQ.plain_gemv(x, qw, sc, zp, 4)
    torch.testing.assert_close(got, ref, atol=2e-5 * ref.abs().max().item(), rtol=0)
    w4a8 = TQ.plain_w4a8(x, qw, sc, zp, 4, 512)
    got = TQ.plain_w4a8g(x, qw, sc, zp, 4, 512)
    torch.testing.assert_close(got, w4a8, atol=2e-5 * w4a8.abs().max().item(), rtol=0)


# (M, K, N, G, bits, asym, rms, W, scales): the reference's probe runs on
# its layer-stacked storage, [L, N/W, R, W].
STREAM = {
    "m4_int4": (4, 1024, 256, 128, 4, False, False, 128, "bf16"),
    "m3_asym_fused_norm": (3, 512, 256, 32, 4, True, True, 128, "f32"),
    "m70_int8_prefill": (70, 1024, 256, 128, 8, False, False, 128, "bf16"),
    "m2_asym_two_kblocks": (2, 4096, 128, 128, 4, True, False, 128, "f32"),
}


@pytest.fixture
def stream_only(monkeypatch):
    """QUANT_STREAM_ONLY=1 for the reference, whose jitted quant_matmul reads
    the variable while tracing: its caches are dropped on both sides."""
    monkeypatch.setenv("QUANT_STREAM_ONLY", "1")
    jax.clear_caches()
    yield
    monkeypatch.delenv("QUANT_STREAM_ONLY")
    jax.clear_caches()


@pytest.mark.parametrize("case", list(STREAM))
def test_plain_stream_matches_the_reference_probe(case, stream_only):
    M, K, N, G, bits, asym, rms, W, scales = STREAM[case]
    L, layer = 2, 1
    layers = [_weights(K, N, G, bits, asym, scales, seed=s) for s in range(L)]
    stacked = [np.stack([JQ.tile_quant_layout(lw[0][i], W) for lw in layers]) for i in range(3)]
    x = _x(M, K)
    gamma = _gamma(K) if rms else None
    want = np.asarray(JQ.quant_matmul(
        jnp.asarray(x), jnp.asarray(stacked[0]), jnp.asarray(stacked[1]),
        jnp.asarray(stacked[2]) if asym else None, bits=bits, backend="tpu", interpret=True,
        symmetric=not asym, layer=jnp.asarray(layer, jnp.int32),
        rms_gamma=None if gamma is None else jnp.asarray(gamma), rms_eps=EPS))
    t_qw, t_sc, t_zp = layers[layer][1]
    got = TQ.quant_matmul(
        torch.from_numpy(x), t_qw, t_sc, t_zp, bits=bits, symmetric=not asym, variant="stream",
        rms_gamma=None if gamma is None else torch.from_numpy(gamma), rms_eps=EPS, tile_n=W)
    np.testing.assert_array_equal(got.numpy(), want[:, :N])
    assert np.all(want[:, :N] == want[0, :N])  # every row the same touch


def test_small_m_slices_fill_the_sms():
    """One K slice (128 weight rows a block) where N / 128 gives 0.9 of a
    block an SM, else 2 or 4 (64 or 32 rows a block), never more."""
    assert TQ.small_m_slices(28672, 132) == 1  # gate_up: 224 blocks
    assert TQ.small_m_slices(128256, 132) == 1
    assert TQ.small_m_slices(15206, 132) == 1 and TQ.small_m_slices(15100, 132) == 2
    assert TQ.small_m_slices(9000, 132) == 2  # 141 blocks of 64 rows
    assert TQ.small_m_slices(6144, 132) == 4  # qkv: 192 blocks of 32 rows
    assert TQ.small_m_slices(4096, 132) == 4  # o, down
    assert TQ.small_m_slices(64, 132) == 4


@pytest.mark.parametrize("variant", ["gemv", "w4a8g"])
def test_plan_picks_the_reference_variant_at_the_edges(variant, capfd):
    """M = 64 keeps the variant, M = 65 sends it to `group` and, on the
    tiled storage the models hold, to `dequant` (an explicit gemv does not
    stay, unlike the port's explicit group); G = 32 keeps gemv and sends
    w4a8g to `dequant`."""
    for M in (1, 64, 65, 128):
        for G in (32, 128):
            K, N, tile = 2048, 2048, 1024
            want = _reference_plan(M, K, N, 4, G, jnp.float32, False, tile, capfd, variant=variant)
            got = TQ.plan(M, K, N, 4, G, 4, False, variant=variant, tile_n=tile)
            assert got == want, (M, G, got, want)
    assert TQ.plan(65, 4096, 4096, 4, 128, 4, False, variant="gemv")[0] == "dequant"
    assert TQ.plan(65, 4096, 4096, 4, 128, 4, False, variant="group")[0] == "group"
    assert TQ.plan(8, 4096, 4096, 4, 32, 4, False, variant="gemv")[0] == "gemv"
    assert TQ.plan(8, 4096, 4096, 4, 32, 4, False, variant="w4a8g")[0] == "dequant"
    # The probe takes the default variant's k-block and prologue.
    for M in (8, 65):
        assert TQ.plan(M, 4096, 6144, 4, 128, 4, True, variant="stream")[1:] == \
            TQ.plan(M, 4096, 6144, 4, 128, 4, True)[1:]


def test_the_cpu_wrappers_refuse_cpu_tensors():
    _, (qw, sc, _) = _weights(256, 64, 128, 4, False, "bf16")
    x = torch.zeros(2, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TQ.quant_gemv_cuda(x, qw, sc, None, 4)
    with pytest.raises(ValueError):
        TQ.quant_w4a8_gemv_cuda(x, qw, sc, None, 4, 256)
    with pytest.raises(ValueError):
        TQ.quant_stream_probe_cuda(x, qw, sc, None, 4, 256)
