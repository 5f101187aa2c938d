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
h = bf16(act(g) * u) with act in f32; then h times down as plain_gemv
computes it: per span of F (gemv_span(G)) the f32 dot with h, (dot -
sum(h) * zero) * scale, summed over the spans. The kernel (one cooperative
launch: gate_up and h, a grid barrier, down) streams x and h through
shared memory, so D has no limit beyond the reference op's.

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
    gemv_span,
    plain_gemv,
    small_m_pad,
    small_m_slices,
)

Triple = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]

# name -> the kernel's act code: 0 silu, 1 gelu in its tanh form.
ACTS = {"silu": 0, "gelu": 1, "gelu_pytorch_tanh": 1, "gelu_new": 1}
MAX_M = 64


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
    x = x.to(torch.bfloat16)
    gu = plain_gemv(x, *gate_up, bits)  # [M, 2F]
    h = (_act(gu[:, :F], act) * gu[:, F:]).to(torch.bfloat16)
    return plain_gemv(h, *down, bits)


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
# x, gu_qweight, gu_scales, gu_zeros, dn_qweight, dn_scales, dn_zeros, xsum,
# h, hsum, out; M, D, F, group_size, bits, scales_bf16, act, k_slices; stream.
ENTRY_POINTS = {"scalellm_quant_mlp": [_P] * 11 + [_I] * 8 + [_P]}


def _library() -> ctypes.CDLL:
    lib = _build.load("quant_mlp")
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def quant_mlp_cuda(x, gate_up: Triple, down: Triple, F: int, bits: int = 4,
                   act: str = "silu") -> torch.Tensor:
    """Launch the fused MLP kernel (one cooperative launch; with zero points
    the sums of x ahead of it, in the same C call) on the current stream;
    returns float32 [M, D]. Raises where the card cannot hold the grid the
    barrier needs. `quant_mlp_cuda.launches` counts the launches."""
    (gq, gs, gz), (dq, ds, dz) = gate_up, down
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"the fused MLP kernel takes bf16 x, got {x.dtype}")
    M, D = x.shape
    if M > MAX_M:
        raise NotImplementedError(f"the fused MLP kernel is for decode: M <= {MAX_M}, got {M}")
    G = D // gs.shape[0]
    if G % 32 or D % 128 or F % 128 or F % G:
        raise NotImplementedError(
            f"the fused MLP kernel needs G % 32 == 0 and D, F multiples of 128 and of G; "
            f"got D={D}, F={F}, G={G}")
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
    if x.data_ptr() % 16 or gq.data_ptr() % 16 or dq.data_ptr() % 16:
        raise NotImplementedError("the fused MLP kernel loads x and the weights by TMA: 16-byte aligned starts")
    dev = x.device
    slices = small_m_slices(D, torch.cuda.get_device_properties(dev).multi_processor_count)
    h = torch.empty(M, F, dtype=torch.bfloat16, device=dev)
    xsum = hsum = None
    if gz is not None:  # the sums of x per span of D and of h per 32 columns of F
        xsum = torch.empty(D // gemv_span(G), small_m_pad(M), dtype=torch.float32, device=dev)
        hsum = torch.empty(F // 32, small_m_pad(M), dtype=torch.float32, device=dev)
    out = torch.empty(M, D, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _library().scalellm_quant_mlp(
        x.data_ptr(), gq.data_ptr(), gs.data_ptr(), ptr(gz), dq.data_ptr(), ds.data_ptr(), ptr(dz),
        ptr(xsum), h.data_ptr(), ptr(hsum), out.data_ptr(), M, D, F, G, bits,
        int(gs.dtype == torch.bfloat16), ACTS[act], slices, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_mlp kernel launch failed: CUDA error {rc}")
    quant_mlp_cuda.launches += 1
    return out


quant_mlp_cuda.launches = 0
