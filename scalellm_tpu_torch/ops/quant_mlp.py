"""Fused weight-only quantized MLP for decode: gate_up -> act(gate) * up ->
down in one call, with the plain PyTorch version and the CUDA wrapper.

Counterpart of scalellm_tpu/ops/quant_mlp.py, a standalone op that no model
calls; the port wires it into no model either. A CUDA tensor goes to the
hand-written kernel of csrc/quant_mlp.cu, a CPU tensor to plain_quant_mlp,
which repeats the kernel's arithmetic. Decode only: above M = 64 the CUDA
path raises (it does not fall back to two quant_matmul calls).

Weights are in the kernel layout of ops/quant_matmul.py, as triples
(qweight, scales, zeros or None):
  gate_up  qweight [2F, D/2] (int8: [2F, D]), scales [D/G, 2F]: output
           columns [0, F) are gate, [F, 2F) up, as in the models' fused
           gate_up_proj;
  down     qweight [D, F/2] (int8: [D, F]), scales [F/G, D].
weights_from_tiled() converts the reference op's tiled operands (gate tiles
then up tiles). The output is float32 [M, D].

What it computes (the kernel's order): g and u as plain_gemv computes them;
h = bf16(act(g) * u) with act in f32; per group of G rows of down the f32
dot with h, (dot - sum(h) * zero) * scale, added in group order within a
slice of BF = max(128, G) rows, and the slices' sums added in slice order.

The activations are the reference op's own table, not ACT2FN: "gelu" there
is jax.nn.gelu, whose default is the tanh form.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops.quant_matmul import (
    DEFAULT_TILE_N,
    from_tiled_quant,
    plain_gemv,
    unpack_signed,
)

Triple = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]

# name -> the kernel's act code: 0 silu, 1 gelu in its tanh form.
ACTS = {"silu": 0, "gelu": 1, "gelu_pytorch_tanh": 1, "gelu_new": 1}
MAX_M = 64
SPAN = 128  # a slice of F is max(SPAN, G) columns


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    if ACTS[act] == 0:
        return g * torch.sigmoid(g)
    c = math.sqrt(2.0 / math.pi)
    return g * (0.5 * (1.0 + torch.tanh(c * (g + 0.044715 * (g * g * g)))))


def weights_from_tiled(gu_qweight, gu_scales, gu_zeros, dn_qweight, dn_scales, dn_zeros,
                       F: int, D: int) -> Tuple[Triple, Triple]:
    """The reference op's tiled operands (gate_up [2F/W, D(/2), W] with gate
    tiles [0, F/W) then up tiles [F/W, 2F/W); down [n/Wd, F(/2), Wd]) ->
    the (gate_up, down) triples of quant_mlp. Zeros may be None."""
    return (from_tiled_quant(gu_qweight, gu_scales, gu_zeros, 2 * F),
            from_tiled_quant(dn_qweight, dn_scales, dn_zeros, D))


def _check(x, gate_up: Triple, down: Triple, F: int, bits: int, act: str,
           tile_n: int, block_f: int) -> int:
    """The reference op's constraints as ValueErrors; returns G."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; the op takes {sorted(ACTS)}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.dim() != 2:
        raise ValueError(f"x must be [M, D], got {tuple(x.shape)}")
    M, D = x.shape
    pack = 2 if bits == 4 else 1
    (gq, gs, _), (dq, ds, _) = gate_up, down
    if gq.shape != (2 * F, D // pack) or gs.shape[1] != 2 * F or D % gs.shape[0]:
        raise ValueError(f"gate_up {tuple(gq.shape)}/{tuple(gs.shape)} does not match D={D}, F={F}")
    G = D // gs.shape[0]
    if dq.shape != (D, F // pack) or ds.shape != (F // G, D):
        raise ValueError(f"down {tuple(dq.shape)}/{tuple(ds.shape)} does not match D={D}, F={F}, G={G}")
    W = min(tile_n, 2 * F)  # the reference's stored tile width
    bf = min(block_f, W)
    if F % W:
        raise ValueError(f"F={F} must be a multiple of the tile width {W} (gate and up halves)")
    if W % bf or bf % G:
        raise ValueError(f"tile width {W}, F-block {bf} and group {G} must nest")
    return G


def plain_quant_mlp(x, gate_up: Triple, down: Triple, F: int, bits: int = 4,
                    act: str = "silu") -> torch.Tensor:
    """What csrc/quant_mlp.cu computes, in float32 [M, D]. x is cast to
    bf16 first, as the kernel takes it."""
    M, D = x.shape
    x = x.to(torch.bfloat16)
    (gq, gs, gz), (dq, ds, dz) = gate_up, down
    G = D // gs.shape[0]
    gu = plain_gemv(x, gq, gs, gz, bits)  # [M, 2F]
    h = (_act(gu[:, :F], act) * gu[:, F:]).to(torch.bfloat16).float()
    n_g = F // G
    w = unpack_signed(dq, bits).float().T.reshape(n_g, G, D)
    hg = h.reshape(M, n_g, G).transpose(0, 1)  # [groups, M, G]
    dots = torch.bmm(hg, w)
    if dz is not None:
        dots = dots - hg.sum(dim=2)[:, :, None] * dz.float()[:, None, :]
    v = dots * ds.float()[:, None, :]  # [groups, M, D]
    per = max(SPAN, G) // G
    out = None
    for s in range(0, n_g, per):
        p = v[s]
        for j in range(1, per):
            p = p + v[s + j]
        out = p if out is None else out + p
    return out


def quant_mlp(x: torch.Tensor, gate_up: Triple, down: Triple, F: int, bits: int = 4,
              act: str = "silu", symmetric: bool = False, tile_n: int = DEFAULT_TILE_N,
              block_f: int = 1024) -> torch.Tensor:
    """down(act(x @ gate) * (x @ up)), float32 [M, D]: the kernel for a CUDA
    tensor, the plain version for a CPU tensor. symmetric (or zeros None)
    skips the zero points. tile_n and block_f are the reference op's
    stored tile width and F-block, whose constraints are checked."""
    _check(x, gate_up, down, F, bits, act, tile_n, block_f)
    if symmetric:
        gate_up, down = (gate_up[0], gate_up[1], None), (down[0], down[1], None)
    if x.device.type == "cpu":
        return plain_quant_mlp(x, gate_up, down, F, bits, act)
    return quant_mlp_cuda(x.to(torch.bfloat16), gate_up, down, F, bits, act)


# ---------------------------------------------------------------- CUDA wrapper

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, gu_qweight, gu_scales, gu_zeros, dn_qweight, dn_scales, dn_zeros, part,
# out; M, D, F, group_size, bits, scales_bf16, act, rows_tile; stream.
ENTRY_POINTS = {"scalellm_quant_mlp": [_P] * 9 + [_I] * 8 + [_P]}
SMEM_BYTES = 232448  # shared memory a block can have on sm_90


def _library() -> ctypes.CDLL:
    lib = _build.load("quant_mlp")
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def rows_tile(M: int, D: int, G: int) -> int:
    """Rows of x a block holds in shared memory (1, 4, 8 or 16); 0 when
    not even one row fits."""
    bf = max(SPAN, G)
    want = 1 if M <= 1 else 4 if M <= 4 else 8 if M <= 8 else 16
    for rows in (16, 8, 4, 1):
        if rows <= want and rows * (D * 2 + 3 * bf * 4 + (bf // G) * 4) <= SMEM_BYTES:
            return rows
    return 0


def quant_mlp_cuda(x, gate_up: Triple, down: Triple, F: int, bits: int = 4,
                   act: str = "silu") -> torch.Tensor:
    """Launch the fused MLP kernel (and its slice sum, one C call) on the
    current stream; returns float32 [M, D]. `quant_mlp_cuda.launches` counts
    the launches."""
    (gq, gs, gz), (dq, ds, dz) = gate_up, down
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"the fused MLP kernel takes bf16 x, got {x.dtype}")
    M, D = x.shape
    if M > MAX_M:
        raise NotImplementedError(f"the fused MLP kernel is for decode: M <= {MAX_M}, got {M}")
    G = D // gs.shape[0]
    bf = max(SPAN, G)
    if G % 32 or (SPAN % G and G % SPAN) or F % bf or D % SPAN:
        raise NotImplementedError(
            f"the fused MLP kernel needs G % 32 == 0 nesting with 128, F % {bf} == 0 and "
            f"D % 128 == 0; got D={D}, F={F}, G={G}")
    if gs.dtype != ds.dtype or gs.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"scales must be f32 or bf16 alike, got {gs.dtype}, {ds.dtype}")
    if (gz is None) != (dz is None):
        raise ValueError("gate_up and down must both have zero points or neither")
    for name, t in (("x", x), ("gate_up qweight", gq), ("gate_up scales", gs), ("gate_up zeros", gz),
                    ("down qweight", dq), ("down scales", ds), ("down zeros", dz)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rows = rows_tile(M, D, G)
    if rows == 0:
        raise NotImplementedError(f"one row of x (D={D}) does not fit in shared memory")
    part = torch.empty(F // bf, M, D, dtype=torch.float32, device=x.device)
    out = torch.empty(M, D, dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _library().scalellm_quant_mlp(
        x.data_ptr(), gq.data_ptr(), gs.data_ptr(), ptr(gz), dq.data_ptr(), ds.data_ptr(), ptr(dz),
        part.data_ptr(), out.data_ptr(), M, D, F, G, bits, int(gs.dtype == torch.bfloat16),
        ACTS[act], rows, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_mlp kernel launch failed: CUDA error {rc}")
    quant_mlp_cuda.launches += 1
    return out


quant_mlp_cuda.launches = 0
