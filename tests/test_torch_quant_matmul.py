"""scalellm_tpu_torch/ops/quant_matmul.py against the JAX package's
ops/quant_matmul.py on the CPU, from numpy-seeded inputs handed to both.

- ref_quant_matmul against the JAX one.
- Each kernel's plain version against the Pallas kernel it stands for, run
  in interpret mode (quant_matmul(..., backend="tpu", interpret=True)).
- The dispatcher's variant, block_k and prologue decisions against the ones
  the JAX dispatcher prints (QUANT_DEBUG) for weights in its tiled storage.
- The ctypes argument lists against the C signatures of csrc/quant_matmul.cu.

Tolerances, f32 outputs of magnitude `top`: the integer dots of W4A8 and
the bf16 x int products are exact on both sides, and the activation scale
is absmax * (1 / 127) on both (XLA evaluates the reference's division by a
constant so), so what differs is the order of f32 sums over groups and
k-blocks: 2e-5 * top. With the RMSNorm prologue a last-bit difference of
the two rsqrt implementations can move a normed activation by a bf16 step
(and with it a quantized activation by 1), which moves that output row by
up to 2e-3 * top (one activation step times one weight): there no element
is off by more than 2e-3 * top, and at most 5% of the rows by more than
2e-5 * top.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.ops import quant_matmul as JQ
from scalellm_tpu_torch.ops import quant_matmul as TQ

EPS = 1e-5


def _bf16_np(t: torch.Tensor):
    import ml_dtypes

    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _case(K, N, G, bits, asym, scales="bf16", seed=0):
    """A quantized weight in both packages' layouts, with random zero points
    when asym. Returns (jax canonical triple, torch kernel-layout triple)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    qw, sc, zp = (JQ.quantize_int4 if bits == 4 else JQ.quantize_int8)(w, G)
    if asym:
        lo, hi = (-8, 8) if bits == 4 else (-20, 20)
        zp = rng.integers(lo, hi, zp.shape).astype(np.int8)
    if scales == "f32":  # what an AWQ/GPTQ checkpoint's f16 scales load as
        sc = sc.astype(np.float16).astype(np.float32) * np.float32(1.001)
        t_sc = torch.from_numpy(sc.copy())
    else:
        t_sc = torch.from_numpy(np.asarray(sc).view(np.int16).copy()).view(torch.bfloat16)
    t_qw = TQ.to_kernel_layout(torch.from_numpy(qw.copy()))
    return (qw, sc, zp), (t_qw, t_sc, torch.from_numpy(zp.copy()) if asym else None)


def _x(M, K, seed=1):
    # Non-zero mean: an unsigned nibble unpack would shift every output by
    # 8 * sum(x) * scale, which zero-mean activations can hide.
    return (np.random.default_rng(seed).standard_normal((M, K)) + 0.5).astype(np.float32)


# ------------------------------------------------------------ float reference


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_ref_quant_matmul_matches_jax(bits, asym):
    (qw, sc, zp), (t_qw, t_sc, t_zp) = _case(256, 96, 64, bits, asym)
    x = _x(7, 256)
    want = np.asarray(JQ.ref_quant_matmul(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(sc),
                                          jnp.asarray(zp), bits))
    got = TQ.ref_quant_matmul(torch.from_numpy(x), t_qw, t_sc, t_zp, bits).numpy()
    # f32 in, f32 out: the two matmuls sum in another order.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(JQ.ref_quant_matmul(jnp.asarray(_bf16_np(xb)), jnp.asarray(qw),
                                          jnp.asarray(sc), jnp.asarray(zp), bits)
                      ).astype(np.float32)
    got = TQ.ref_quant_matmul(xb, t_qw, t_sc, t_zp, bits).float().numpy()
    # bf16 out: one bf16 step (2**-8 relative) where the f32 sums straddle a
    # rounding boundary.
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -8 * np.abs(want).max())


# ------------------------------------------------------------ plain vs Pallas


def _interpret(x, jax_triple, bits, asym, variant, block_k, gamma, tile=0):
    qw, sc, zp = jax_triple
    if tile:
        qw, sc, zp = (JQ.tile_quant_layout(a, tile) for a in (qw, sc, zp))
    return np.asarray(JQ.quant_matmul(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(sc), jnp.asarray(zp) if asym else None,
        bits=bits, backend="tpu", interpret=True, symmetric=not asym, variant=variant,
        block_k=block_k, rms_gamma=None if gamma is None else jnp.asarray(gamma), rms_eps=EPS))


def _compare(got: torch.Tensor, want: np.ndarray, rms: bool):
    top = np.abs(want).max()
    diff = np.abs(got.numpy() - want)
    rows_off = (diff.max(axis=1) > 2e-5 * top).mean()
    assert diff.max() <= (2e-3 if rms else 2e-5) * top, (diff.max(), top)
    assert rows_off <= 0.05, (rows_off, diff.max(), top)


# (M, K, N, G, bits, asym, rms, block_k, scales): block_k pinned on both
# sides (0: the dispatchers' own choice, which must then agree too).
W4A8 = {
    "m1_two_kblocks": (1, 512, 128, 128, 4, False, False, 256, "bf16"),
    "m8_asym_one_block": (8, 512, 128, 128, 4, True, False, 512, "f32"),
    "m64_four_kblocks": (64, 1024, 256, 128, 4, False, False, 256, "bf16"),
    "m8_rms_dispatch": (8, 1024, 128, 128, 4, False, True, 0, "bf16"),
    "m8_asym_rms_dispatch": (8, 512, 128, 128, 4, True, True, 0, "f32"),
    "m64_dispatch_k4096": (64, 4096, 128, 128, 4, False, False, 0, "bf16"),
    "m1_dispatch": (1, 1024, 256, 128, 4, True, False, 0, "f32"),
    "m8_int8_two_kblocks": (8, 512, 128, 128, 8, False, False, 256, "bf16"),
    "m64_int8_asym_rms": (64, 512, 128, 128, 8, True, True, 0, "bf16"),
    # G = 256: the kernels fold each 128-K span, the reference each group.
    "m8_g256_asym_two_kblocks": (8, 1024, 128, 256, 4, True, False, 512, "f32"),
    "m16_int8_g256": (16, 512, 128, 256, 8, False, False, 512, "bf16"),
}


@pytest.mark.parametrize("case", list(W4A8))
def test_plain_w4a8_matches_the_pallas_kernel(case):
    M, K, N, G, bits, asym, rms, block_k, scales = W4A8[case]
    jt, (t_qw, t_sc, t_zp) = _case(K, N, G, bits, asym, scales)
    x = _x(M, K)
    gamma = np.random.default_rng(2).uniform(0.5, 1.5, K).astype(np.float32) if rms else None
    want = _interpret(x, jt, bits, asym, "w4a8", block_k, gamma)
    got = TQ.quant_matmul(
        torch.from_numpy(x), t_qw, t_sc, t_zp, bits=bits, symmetric=not asym, variant="w4a8",
        block_k=block_k, rms_gamma=None if gamma is None else torch.from_numpy(gamma),
        rms_eps=EPS, tile_n=4096)  # flat layout on the JAX side: its block_n default
    assert got.dtype == torch.float32
    _compare(got, want, rms)


# (M, K, N, G, bits, asym, rms, scales)
TILE = {
    "m8_g128": (8, 512, 128, 128, 4, False, False, "bf16"),
    "m8_g128_asym_rms": (8, 512, 128, 128, 4, True, True, "f32"),
    "m128_asym": (128, 512, 256, 128, 4, True, False, "f32"),
    "m128_rms_several_kblocks": (128, 1024, 128, 128, 4, False, True, "bf16"),
    "m8_int8_asym": (8, 256, 128, 128, 8, True, False, "bf16"),
}


@pytest.mark.parametrize("variant", ["group", "dequant"])
@pytest.mark.parametrize("case", list(TILE))
def test_plain_group_and_dequant_match_the_pallas_kernels(case, variant):
    M, K, N, G, bits, asym, rms, scales = TILE[case]
    jt, (t_qw, t_sc, t_zp) = _case(K, N, G, bits, asym, scales)
    x = _x(M, K)
    gamma = np.random.default_rng(2).uniform(0.5, 1.5, K).astype(np.float32) if rms else None
    want = _interpret(x, jt, bits, asym, variant, 0, gamma)
    got = TQ.quant_matmul(
        torch.from_numpy(x), t_qw, t_sc, t_zp, bits=bits, symmetric=not asym, variant=variant,
        rms_gamma=None if gamma is None else torch.from_numpy(gamma), rms_eps=EPS)
    _compare(got, want, rms)


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("M", [8, 128])
def test_group_32_goes_to_dequant_like_the_reference(M, asym):
    """G < 128: both dispatchers turn every variant into `dequant`."""
    jt, (t_qw, t_sc, t_zp) = _case(256, 128, 32, 4, asym, "f32")
    x = _x(M, 256)
    want = _interpret(x, jt, 4, asym, "", 0, None)
    assert TQ.plan(M, 256, 128, 4, 32, 4, False)[0] == "dequant"
    got = TQ.quant_matmul(torch.from_numpy(x), t_qw, t_sc, t_zp, bits=4, symmetric=not asym)
    _compare(got, want, False)


def test_bf16_activations_give_bf16_within_one_step():
    jt, (t_qw, t_sc, _) = _case(512, 128, 128, 4, False)
    xb = torch.from_numpy(_x(8, 512)).to(torch.bfloat16)
    for variant in TQ.MATMUL_VARIANTS:
        want = _interpret(_bf16_np(xb), jt, 4, False, variant, 256, None).astype(np.float32)
        got = TQ.quant_matmul(xb, t_qw, t_sc, None, bits=4, symmetric=True, variant=variant,
                              block_k=256)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(want).max())


def test_sign_extension_of_the_nibbles():
    """Every nibble value in every position, against the arithmetic done by
    hand: a weight of -8..7, not 0..15."""
    values = torch.arange(16, dtype=torch.uint8).repeat(2)[:, None].repeat(1, 8)  # [K=32, N=8]
    values[:, 1::2] = values[:, 1::2].flip(0)
    qw = TQ.to_kernel_layout(TQ.pack_int4(values))
    assert torch.equal(TQ.unpack_signed(qw, 4).T.to(torch.int32), values.to(torch.int32) - 8)
    x = torch.ones(1, 32)
    s = torch.ones(1, 8)
    want = (values.float() - 8).sum(0, keepdim=True)
    for variant in ("ref",) + TQ.MATMUL_VARIANTS:
        got = TQ.quant_matmul(x, qw, s, None, bits=4, symmetric=True, variant=variant)
        assert torch.equal(got, want), variant


# ------------------------------------------------------------ dispatcher


def _reference_plan(M, K, N, bits, G, scales_dtype, rms, tile, capfd, variant=""):
    """What the JAX dispatcher decides for a tiled weight, read from its
    QUANT_DEBUG line while the call is traced with abstract values (nothing
    is computed)."""
    n_n, W = -(-N // min(tile, N)), min(tile, N)
    rows = K // 2 if bits == 4 else K
    sds = jax.ShapeDtypeStruct
    args = (sds((M, K), jnp.bfloat16), sds((n_n, rows, W), jnp.int8),
            sds((n_n, K // G, W), scales_dtype))
    gamma = sds((K,), jnp.bfloat16) if rms else None
    os.environ["QUANT_DEBUG"] = "1"
    try:
        jax.eval_shape(
            lambda x, q, s, g: JQ.quant_matmul.__wrapped__(
                x, q, s, None, bits=bits, backend="tpu", interpret=True, symmetric=True,
                variant=variant, rms_gamma=g, rms_eps=EPS),
            *args, gamma)
    finally:
        os.environ.pop("QUANT_DEBUG", None)
    line = [ln for ln in capfd.readouterr().err.splitlines() if ln.startswith("quant_matmul M=")][-1]
    fields = dict(f.split("=") for f in line.split()[1:])
    return fields["variant"], int(fields["bk"]), fields["fuse_rms"] == "True"


# The Llama-3.1-8B projections (K, N, bits, tile, norm before it) and a few
# awkward K: odd multiples of 8 * G (2816, 5120), a K / G that is no multiple
# of 8 (3584), and one that fills the k-block cap (8192). Every K here is a
# multiple of the group size 128, which the reference asserts.
PLAN_SHAPES = {
    "qkv": (4096, 6144, 4, 1024, True),
    "o_proj": (4096, 4096, 4, 1024, False),
    "gate_up": (4096, 28672, 4, 1024, True),
    "down_proj": (14336, 4096, 4, 1024, False),
    "lm_head_int8": (4096, 128256, 8, 2048, False),
    "lm_head_int4": (4096, 128256, 4, 2048, False),
    "k2816": (2816, 1024, 4, 1024, True),
    "k5120": (5120, 5120, 4, 1024, True),
    "k3584": (3584, 2048, 4, 1024, False),
    "k8192": (8192, 1024, 4, 1024, True),
}


@pytest.mark.parametrize("M", [1, 16, 64, 128, 512])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_plan_matches_the_reference_dispatcher(shape, M, capfd):
    K, N, bits, tile, rms = PLAN_SHAPES[shape]
    for scales_dtype, itemsize in ((jnp.bfloat16, 2), (jnp.float32, 4)):
        want = _reference_plan(M, K, N, bits, 128, scales_dtype, rms, tile, capfd)
        got = TQ.plan(M, K, N, bits, 128, itemsize, rms, tile_n=tile)
        assert got == want, (scales_dtype, got, want)


def test_plan_on_the_8b_model_path():
    """What the dispatcher picks at the Llama-3.1-8B projections: the numbers
    the kernels' notes and the measurements speak of."""
    assert TQ.plan(16, 4096, 6144, 4, 128, 4, True) == ("w4a8", 4096, True)
    assert TQ.plan(16, 4096, 4096, 4, 128, 4, False) == ("w4a8", 2048, False)
    assert TQ.plan(16, 14336, 4096, 4, 128, 4, False) == ("w4a8", 2048, False)
    assert TQ.plan(8, 4096, 128256, 8, 128, 2, False, tile_n=TQ.LM_HEAD_TILE_N) == ("w4a8", 2048, False)
    assert TQ.plan(512, 4096, 28672, 4, 128, 4, True)[::2] == ("dequant", False)
    assert TQ.plan(512, 4096, 4096, 4, 128, 4, False, variant="group")[0] == "group"


def test_cpu_dispatch_refuses_bad_arguments():
    _, (t_qw, t_sc, _) = _case(256, 64, 128, 4, False)
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError):
        TQ.quant_matmul(x, t_qw, t_sc, bits=3)
    with pytest.raises(ValueError):
        TQ.quant_matmul(x, t_qw, t_sc, variant="block_diagonal")
    with pytest.raises(ValueError):
        TQ.quant_matmul(x[:, :128], t_qw, t_sc)
    with pytest.raises(ValueError):
        TQ.quant_matmul_w4a8_cuda(x.to(torch.bfloat16), t_qw, t_sc, None, 4, 256)


@pytest.mark.parametrize("M,K,G", [(65, 1024, 128), (8, 512, 64), (8, 1152, 192), (8, 65536, 128)])
def test_w4a8_kernels_refuse_what_they_do_not_take(M, K, G):
    """M past 64, a group that is no multiple of 128 (the integer mainloop
    folds 128-K spans, each inside one group: int8 at G = 64 is refused
    since it), K past 32768; a block_k that is no multiple of G dividing K
    is a ValueError."""
    for name in ("w4a8", "w4a8g"):
        with pytest.raises(NotImplementedError):
            TQ.check_w4a8(name, M, K, G, K)
    TQ.check_w4a8("w4a8", 64, 4096, 256, 2048)
    with pytest.raises(ValueError):
        TQ.check_w4a8("w4a8", 16, 4096, 256, 384)


# ------------------------------------------------------------ ctypes


def _entry_points():
    """Every C entry point of the port's kernels: name -> (its argtypes, its
    source under csrc/)."""
    from scalellm_tpu_torch.ops import grouped_matmul, mla_attention, moe_quant, quant_mlp

    tables = ((TQ.ENTRY_POINTS, "quant_matmul.cu"), (TQ.GEMV_ENTRY_POINTS, "quant_gemv.cu"),
              (quant_mlp.ENTRY_POINTS, "quant_mlp.cu"),
              (mla_attention.ENTRY_POINTS, "mla_attention.cu"),
              (grouped_matmul.ENTRY_POINTS, "grouped_matmul.cu"),
              (moe_quant.ENTRY_POINTS, "moe_quant.cu"),
              (moe_quant.DEQUANT_ENTRY_POINTS, "expert_dequant.cu"))
    return {entry: (table[entry], source) for table, source in tables for entry in table}


@pytest.mark.parametrize("entry", list(_entry_points()))
def test_ctypes_signatures_match_the_cuda_source(entry):
    """Each wrapper's argtypes follow its C entry point's parameter list in
    its csrc/ source, so no argument is passed with another type or width."""
    import ctypes
    import pathlib
    import re

    argtypes, source = _entry_points()[entry]
    src = (pathlib.Path(TQ.__file__).parent.parent / "csrc" / source).read_text()
    params = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src, re.S).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    want = []
    for p in params.split(","):
        words = p.replace("*", " * ").split()[:-1]  # drop the parameter name
        want.append(kinds["void*" if "*" in words else words[-1]])
    assert argtypes == want


# (M, K, N, variant) -> the tile kernel's block shape (weight rows, tokens)
# on a card of 132 SMs: the token tile from M up to 64; above that the
# cheapest grid (192-row tiles only for dequant, where N is large).
TILE_CHOICES = {
    (16, 2816, 2048, "dequant"): (64, 32),  # the DeepSeek shared down at decode
    (64, 4096, 4096, "group"): (64, 64),
    (65, 1024, 2050, "dequant"): (64, 64),  # two token tiles of 64, 33 column tiles
    (512, 4096, 28672, "dequant"): (192, 128),  # 8B gate_up
    (512, 4096, 28672, "group"): (128, 128),
    (512, 4096, 6144, "dequant"): (192, 128),  # qkv: 128 blocks, one wave
    (512, 4096, 4096, "dequant"): (128, 128),  # o, down: 128 blocks
    (128, 2048, 2560, "dequant"): (64, 64),  # a TinyLlama qkv: few column tiles
}


@pytest.mark.parametrize("case", list(TILE_CHOICES))
def test_tile_shape_choice(case):
    M, K, N, variant = case
    assert TQ.TILES[TQ.tile_shape(variant, M, K, N, 128)] == TILE_CHOICES[case]
    assert TQ.tile_shape(variant, M, K, N, 128) in ((0, 1) if M <= 64 else TQ.LARGE_TILES[variant])


@pytest.mark.parametrize("K,N,G", [(96, 64, 48), (256, 64, 16), (80, 64, 80), (256, 63, 128)])
def test_tile_shape_refuses_what_the_kernel_does_not_take(K, N, G):
    """Group sizes that are not a multiple of 32 (each 32-K span of a stage
    takes the scales of one group), K not a multiple of 32, odd N."""
    with pytest.raises(NotImplementedError):
        TQ.tile_shape("dequant", 128, K, N, G)


@pytest.mark.parametrize("K,G", [(576, 96), (960, 160), (2080, 2080)])
def test_tile_shape_takes_any_group_of_32s(K, G):
    """G = 96 and 160 (a stage's two 32-K spans may fall in two groups) and
    one channel-wise group with K % 64 == 32."""
    for variant in ("group", "dequant"):
        assert TQ.tile_shape(variant, 128, K, 256, G) in TQ.LARGE_TILES[variant]
