"""scalellm_tpu_torch/ops/quant_mlp.py (the fused quantized MLP, K11)
against the JAX package's Pallas kernel, on the CPU, from numpy-seeded
inputs.

The JAX op runs its Pallas kernel only on a TPU (it has no interpret
switch); on the CPU it runs two quant_matmul calls with bf16 rounding in
between, which is another function. So the test builds the op's own
pallas_call (ops/quant_mlp.py:192-240: the same grid, block specs and
kernel body, _mlp_kernel) with interpret=True, on the reference's tiled
operands, and holds the port's plain version, on the same weights converted
by weights_from_tiled, against it.

Tolerance: both compute g and u as f32 sums of exact products (per group
there, per span of K here), round h = act(g) * u to bf16 (where the two
activations' last bits or the sums' order fall on a rounding boundary, an
element of h moves by one bf16 step, 2**-8 of it, which moves an output by
about 1e-4 of the largest), then sum exact products of h in f32 in another
order: 2e-4 of the output's largest magnitude, and a mean error below 2e-6
of it (measured: 1.6e-7 and 2.3e-8; the erf GELU in place of the tanh one
is off by 3e-2 and more).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scalellm_tpu.ops import quant_matmul as JQ
from scalellm_tpu.ops import quant_mlp as JM
from scalellm_tpu_torch.ops import quant_mlp as TM


def _pallas_mlp(x, gu_qw, gu_sc, gu_zp, dn_qw, dn_sc, dn_zp, *, F, bits, act, symmetric,
                block_f=1024):
    """The reference op's pallas_call (scalellm_tpu/ops/quant_mlp.py:178-240)
    in interpret mode."""
    M, D = x.shape
    n_n, _, W = gu_qw.shape
    n_dn, _, Wd = dn_qw.shape
    pack = 2 if bits == 4 else 1
    G = D // gu_sc.shape[-2]
    bf = min(block_f, W)
    n_f_tiles, n_f, sub = F // W, F // bf, W // bf

    def gate_idx(f):
        return (f // sub, 0, f % sub)

    def up_idx(f):
        return (n_f_tiles + f // sub, 0, f % sub)

    gu_w_spec = lambda imap: pl.BlockSpec((1, D // pack, bf), imap, memory_space=pltpu.VMEM)
    gu_s_spec = lambda imap: pl.BlockSpec((1, D // G, bf), imap, memory_space=pltpu.VMEM)
    d_w_spec = pl.BlockSpec((n_dn, bf // pack, Wd), lambda f: (0, f, 0), memory_space=pltpu.VMEM)
    d_s_spec = pl.BlockSpec((n_dn, bf // G, Wd), lambda f: (0, f, 0), memory_space=pltpu.VMEM)
    in_specs = [pl.BlockSpec((M, D), lambda f: (0, 0), memory_space=pltpu.VMEM),
                gu_w_spec(gate_idx), gu_s_spec(gate_idx), gu_w_spec(up_idx), gu_s_spec(up_idx),
                d_w_spec, d_s_spec]
    operands = [x.astype(jnp.bfloat16), gu_qw, gu_sc, gu_qw, gu_sc, dn_qw, dn_sc]
    if not symmetric:
        in_specs += [gu_s_spec(gate_idx), gu_s_spec(up_idx), d_s_spec]
        operands += [gu_zp, gu_zp, dn_zp]
    kernel = functools.partial(JM._mlp_kernel, n_f=n_f, n_dn=n_dn, bits=bits,
                               symmetric=symmetric, act=act)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((M, n_dn, Wd), jnp.float32),
        grid=(n_f,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((M, n_dn, Wd), lambda f: (0, 0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((M, n_dn, Wd), jnp.float32)],
        interpret=True,
    )(*operands)
    return out.reshape(M, n_dn * Wd)


def _operands(M, D, F, G, W, bits, asym, seed=0, w_down=None):
    """Quantized gate, up and down weights (random zero points when asym) in
    the reference's tiled storage (down's tile width w_down, W by default),
    and x."""
    rng = np.random.default_rng(seed)
    quantize = JQ.quantize_int4 if bits == 4 else JQ.quantize_int8
    gu = (rng.standard_normal((D, 2 * F)) * 0.08).astype(np.float32)  # gate | up
    dn = (rng.standard_normal((F, D)) * 0.08).astype(np.float32)
    out = []
    for w, width in ((gu, W), (dn, w_down or W)):
        qw, sc, zp = quantize(w, G)
        if asym:
            lo, hi = (-8, 8) if bits == 4 else (-20, 20)
            zp = rng.integers(lo, hi, zp.shape).astype(np.int8)
        out.append(tuple(JQ.tile_quant_layout(a, width) for a in (qw, sc, zp)))
    x = (rng.standard_normal((M, D)) + 0.3).astype(np.float32)
    return x, out[0], out[1]


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


# (M, D, F, G, W, bits, asym, act)
CASES = {
    "m3_silu_asym": (3, 256, 256, 128, 128, 4, True, "silu"),
    "m1_gelu_two_f_tiles": (1, 256, 512, 128, 256, 4, False, "gelu"),
    "m5_g32_gelu_asym": (5, 256, 256, 32, 128, 4, True, "gelu"),
    "m2_int8_gelu_new": (2, 256, 256, 64, 128, 8, True, "gelu_new"),
    # The tensor-core kernel's contract: int4 and int8, symmetric and
    # asymmetric, G = 32 and 128, M = 1, 16, 64.
    "m16_int8_silu": (16, 256, 256, 128, 128, 8, False, "silu"),
    "m64_g32_silu": (64, 256, 256, 32, 128, 4, False, "silu"),
    "m64_int8_g32_asym": (64, 256, 256, 32, 128, 8, True, "silu"),
    "m16_g128_asym": (16, 512, 256, 128, 128, 4, True, "silu"),
    # A D whose row of x the kernel before the small-M mainloop could not
    # hold in shared memory (its rows_tile refused D > 115454 at G = 128):
    # x now streams through the ring.
    "m1_d115456": (1, 115456, 128, 128, 128, 4, False, "silu"),
}
# Down's tile width where it is not W: one tile across the large D keeps
# the interpret-mode kernel's loop over down tiles short.
DOWN_TILE = {"m1_d115456": 115456}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_quant_mlp_matches_the_pallas_kernel(case):
    M, D, F, G, W, bits, asym, act = CASES[case]
    x, gu, dn = _operands(M, D, F, G, W, bits, asym, w_down=DOWN_TILE.get(case))
    want = np.asarray(_pallas_mlp(jnp.asarray(x), *(jnp.asarray(a) for a in gu + dn),
                                  F=F, bits=bits, act=act, symmetric=not asym))[:, :D]
    gate_up, down = TM.weights_from_tiled(*(_torch(a) for a in gu + dn), F=F, D=D)
    got = TM.quant_mlp(torch.from_numpy(x), gate_up, down, F, bits=bits, act=act,
                       symmetric=not asym, tile_n=W)
    assert got.dtype == torch.float32 and got.shape == (M, D)
    top = np.abs(want).max()
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 2e-4 * top, (diff.max(), top)
    assert diff.mean() <= 2e-6 * top, (diff.mean(), top)


def test_gelu_is_the_tanh_form_of_the_reference_table():
    """The op's "gelu" is jax.nn.gelu (tanh), not the erf GELU that the
    models' activation table maps "gelu" to."""
    g = torch.linspace(-4, 4, 101)
    want = np.asarray(JM._ACTS["gelu"](jnp.asarray(g.numpy())))
    np.testing.assert_allclose(TM._act(g, "gelu").numpy(), want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(g)
    assert (TM._act(g, "gelu") - erf).abs().max() > 1e-4
    for name in ("silu", "gelu_pytorch_tanh", "gelu_new"):
        want = np.asarray(JM._ACTS[name](jnp.asarray(g.numpy())))
        np.testing.assert_allclose(TM._act(g, name).numpy(), want, rtol=1e-6, atol=1e-6)


def test_weights_from_tiled_takes_gate_tiles_then_up_tiles():
    """Columns [0, F) of the converted gate_up are the gate projection and
    [F, 2F) the up projection, whatever the tile width; down keeps D."""
    D, F, G = 256, 512, 128
    x, gu, dn = _operands(2, D, F, G, 256, 4, False)
    gate_up, down = TM.weights_from_tiled(*(_torch(a) for a in gu + dn), F=F, D=D)
    flat = [JQ.untile_quant_layout(a) for a in gu]
    assert torch.equal(gate_up[0], torch.from_numpy(flat[0]).T)
    assert gate_up[1].shape == (D // G, 2 * F) and down[0].shape == (D, F // 2)
    assert down[1].shape == (F // G, D) and down[2].shape == (F // G, D)


def test_the_reference_constraints_are_value_errors():
    M, D, F, G = 2, 256, 256, 128
    x, gu, dn = _operands(M, D, F, G, 128, 4, False)
    gate_up, down = TM.weights_from_tiled(*(_torch(a) for a in gu + dn), F=F, D=D)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError):  # F % W: gate and up would share a tile
        TM.quant_mlp(xt, gate_up, down, F, tile_n=384)
    with pytest.raises(ValueError):  # bf % G
        TM.quant_mlp(xt, gate_up, down, F, tile_n=128, block_f=64)
    with pytest.raises(ValueError):
        TM.quant_mlp(xt, gate_up, down, F, act="relu")
    with pytest.raises(ValueError):  # the CUDA wrapper takes CUDA tensors only
        TM.quant_mlp_cuda(xt.to(torch.bfloat16), gate_up, down, F)
    # Above M = 64 the plain version still computes (the kernel raises on the card).
    big = torch.from_numpy(np.random.default_rng(3).standard_normal((65, D)).astype(np.float32))
    assert TM.quant_mlp(big, gate_up, down, F, tile_n=128).shape == (65, D)
