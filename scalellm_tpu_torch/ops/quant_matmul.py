"""Weight-only INT4/INT8 matmul with fused dequantization: host-side packing,
the plain PyTorch versions, the CUDA kernels' wrappers and the dispatcher.

Counterpart of scalellm_tpu/ops/quant_matmul.py. A CUDA tensor goes to the
hand-written Hopper kernels of csrc/quant_matmul.cu; a CPU tensor goes to the
plain versions below, which repeat the kernels' arithmetic. There is no
fallback from one to the other: a CUDA call a kernel does not cover raises.

Two layouts of a quantized [K, N] weight:

  canonical (the reference package's flat layout; pack/quantize produce it)
    qweight  int8 [K/2, N]: byte r holds K=2r in bits 0-3 and K=2r+1 in bits
             4-7, each a SIGNED nibble (the checkpoint's unsigned value - 8);
             int8 quantization: int8 [K, N]
    scales   [K/G, N] (bf16 from the internal quantizers, f32 from AWQ/GPTQ
             checkpoints, whose f16 scales bf16 cannot hold)
    zeros    int8 [K/G, N], shifted by -8 for int4 (symmetric: all 0)

  kernel (what the models store and every matmul here takes)
    qweight  int8 [N, K/2] (int8: [N, K]): the canonical bytes transposed, so
             K is contiguous and 16 bytes of a row are 32 weights of one
             output column; torch's [out, in] convention
    scales, zeros  as canonical; zeros is None for a symmetric weight

Dequantized weight: w = (q - z) * s.

Variants (the reference's, chosen per call by plan()):
  "w4a8"    activations quantized to int8 per (row, k-block of block_k),
            int8 x int8 group dots with int32 sums; decode (M <= 64). Its
            kernel and w4a8g's share the integer tensor-core mainloop of
            csrc/quant_small_m.cuh
  "group"   bf16 x int group dots with f32 sums, scale applied after the dot
  "dequant" weight dequantized to bf16 (two roundings), one bf16 dot; what
            the reference's tiled storage runs for M > 64 and for G < 128
  "gemv"    the group variant's function for small M: per span of K an f32
            dot, folded with its scale and zero point, on tensor cores
            (csrc/quant_gemv.cu, csrc/quant_small_m.cuh); opt-in, any G
  "w4a8g"   the W4A8 function for small M, each 128-K span's integer dot
            folded with its own activation scale; opt-in
  "stream"  the weight-stream probe: reads every weight, scale and zero
            byte and returns the reference probe's one-row "touch", not a
            matmul (timing only)
  "ref"     the float reference (ref_quant_matmul), CPU tensors only
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from scalellm_tpu_torch.ops import _build

# The reference's stored tile widths. Its block_k choice, which is part of
# the W4A8 numerics, depends on them.
DEFAULT_TILE_N = 1024
LM_HEAD_TILE_N = 2048

VARIANTS = ("w4a8", "group", "dequant", "gemv", "w4a8g", "stream")
MATMUL_VARIANTS = VARIANTS[:-1]  # all but the probe compute x @ w

# ---------------------------------------------------------------- packing


def pack_int4(w_unsigned: torch.Tensor) -> torch.Tensor:
    """[K, N] unsigned nibble values (0..15) -> canonical int8 [K/2, N]."""
    assert w_unsigned.shape[0] % 2 == 0
    w = (w_unsigned.to(torch.int32) - 8) & 0xF
    packed = (w[1::2] << 4) | w[0::2]
    return packed.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: canonical int8 [K/2, N] -> uint8 [K, N] (0..15)."""
    p = packed.view(torch.uint8).to(torch.int32)
    out = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=1).reshape(-1, packed.shape[1])
    return ((out + 8) & 0xF).to(torch.uint8)


def _quantize(w: torch.Tensor, group_size: int, qmax: int, qmin: int):
    K, N = w.shape
    assert K % group_size == 0
    g = w.float().reshape(K // group_size, group_size, N)
    max_abs = g.abs().amax(dim=1)
    # The scale goes through its storage type (bf16) BEFORE the grid is
    # computed, so what is stored is what the grid was built against.
    qmax_t = torch.full((), float(qmax), device=w.device)
    scales = torch.clamp(max_abs / qmax_t, min=1e-10).to(torch.bfloat16)
    q = torch.clamp(torch.round(g / scales.float()[:, None, :]), qmin, qmax)
    zeros = torch.zeros(K // group_size, N, dtype=torch.int8, device=w.device)
    return q.reshape(K, N), scales, zeros


def quantize_int4(w: torch.Tensor, group_size: int):
    """Symmetric int4 group quantization of a float [K, N] weight ->
    (canonical int8 [K/2, N], bf16 scales [K/G, N], int8 zeros, all 0)."""
    q, scales, zeros = _quantize(w, group_size, 7, -8)
    return pack_int4((q + 8).to(torch.uint8)), scales, zeros


def quantize_int8(w: torch.Tensor, group_size: int):
    """Symmetric int8 group quantization -> (int8 [K, N], bf16 scales, zeros)."""
    q, scales, zeros = _quantize(w, group_size, 127, -127)
    return q.to(torch.int8), scales, zeros


def to_kernel_layout(qweight: torch.Tensor) -> torch.Tensor:
    """Canonical [K/2 or K, N] -> kernel [N, K/2 or K]: the same bytes,
    K-contiguous. A transpose, so the same call takes a kernel-layout weight
    back."""
    return qweight.T.contiguous()


def untile_quant_layout(arr: torch.Tensor) -> torch.Tensor:
    """The reference's N-blocked storage [*, N_pad/W, R, W] -> flat
    [*, R, N_pad] (keeps the N padding that tiling added)."""
    *lead, n_n, R, W = arr.shape
    return arr.transpose(-3, -2).reshape(*lead, R, n_n * W).contiguous()


def from_tiled_quant(qweight: torch.Tensor, scales: torch.Tensor,
                     zeros: Optional[torch.Tensor], n: int):
    """The reference's N-tiled quantized triple (qweight [N_pad/W, R, W],
    scales and zeros [N_pad/W, K/G, W]; zeros may be None) -> the kernel
    layout of its first n columns: qweight [n, R], scales and zeros [K/G, n]."""
    def flat(t):
        return untile_quant_layout(t)[:, :n]

    return (flat(qweight).T.contiguous(), flat(scales).contiguous(),
            None if zeros is None else flat(zeros).contiguous())


def unpack_signed(qweight: torch.Tensor, bits: int) -> torch.Tensor:
    """Kernel-layout qweight -> the signed integer weights, int8 [N, K]."""
    if bits == 8:
        return qweight
    q = qweight.to(torch.int32)
    lo = ((q & 0xF) ^ 8) - 8
    hi = (((q >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=2).reshape(qweight.shape[0], -1).to(torch.int8)


def quantize_linear(weight: torch.Tensor, bits: int, group_size: int):
    """A dense [out, in] weight -> (kernel-layout qweight, bf16 scales)."""
    fn = quantize_int4 if bits == 4 else quantize_int8
    qw, scales, _ = fn(weight.T.float(), group_size)
    return to_kernel_layout(qw), scales


# ---------------------------------------------------------------- plain versions


def ref_quant_matmul(
    x: torch.Tensor,  # [M, K]
    qweight: torch.Tensor,  # kernel layout
    scales: torch.Tensor,  # [K/G, N]
    zeros: Optional[torch.Tensor],  # int8 [K/G, N] or None
    bits: int,
) -> torch.Tensor:
    """Float reference: x @ ((q - z) * s) in float32, cast to x's type."""
    K = x.shape[-1]
    w = unpack_signed(qweight, bits).to(torch.int32).T  # [K, N]
    G = K // scales.shape[0]
    if zeros is not None:
        w = w - torch.repeat_interleave(zeros.to(torch.int32), G, dim=0)
    wf = w.float() * torch.repeat_interleave(scales.float(), G, dim=0)
    return (x.float() @ wf).to(x.dtype)


def rms_prologue(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The RMSNorm prologue: f32 norm, rounded to x's type before anything
    else reads it."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def _group_operands(x, qweight, scales, bits):
    M, K = x.shape
    n_g = scales.shape[0]
    G = K // n_g
    w = unpack_signed(qweight, bits).float().T.reshape(n_g, G, -1)  # [n_g, G, N]
    return M, K, n_g, G, w


W4A8_SPAN = 128  # K of one integer dot of the W4A8 kernels (inside one group: G % 128 == 0)


def _w4a8_spans(x, qweight, scales, zeros, bits, block_k, rms_gamma, rms_eps, span_sx):
    """The W4A8 kernels' arithmetic in float32 [M, N]: x (bf16) quantized to
    int8 per (row, k-block); per 128-K span an integer dot, dot - sum(xq) *
    zero, times the scale; then, per k-block, the spans' sum times sx
    (span_sx False) or each span times sx (span_sx True), summed over
    k-blocks. The integer dots run as float32 matmuls of integers whose
    partial sums stay below 2**24, so they are exact."""
    if rms_gamma is not None:
        x = rms_prologue(x, rms_gamma, rms_eps)
    M, K = x.shape
    G = K // scales.shape[0]
    span = W4A8_SPAN
    w = unpack_signed(qweight, bits).float().T.reshape(K // span, span, -1)  # [spans, span, N]
    per, per_kb = G // span, block_k // span
    s = scales.float().repeat_interleave(per, 0)  # [spans, N]
    z = None if zeros is None else zeros.float().repeat_interleave(per, 0)
    acc = torch.zeros(M, w.shape[-1], dtype=torch.float32, device=x.device)
    for kb in range(K // block_k):
        xf = x[:, kb * block_k:(kb + 1) * block_k].float()
        # absmax * (1 / 127), not absmax / 127: XLA turns the reference's
        # division by a constant into this multiplication, and the two can
        # differ in the last bit, which flips quantized activations on ties.
        sx = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-10) * (1.0 / 127.0)
        xq = torch.clamp(torch.round(xf / sx), -127, 127)  # round half to even
        xg = xq.reshape(M, per_kb, span).transpose(0, 1)  # [spans, M, span]
        spans = slice(kb * per_kb, (kb + 1) * per_kb)
        dots = torch.bmm(xg, w[spans])  # [spans, M, N]
        if z is not None:
            dots = dots - xg.sum(dim=2)[:, :, None] * z[spans][:, None, :]
        if span_sx:
            acc += (dots * s[spans][:, None, :] * sx).sum(dim=0)
        else:
            acc += (dots * s[spans][:, None, :]).sum(dim=0) * sx
    return acc


def plain_w4a8(x, qweight, scales, zeros, bits, block_k, rms_gamma=None, rms_eps=1e-6):
    """What csrc/quant_matmul.cu:w4a8_kernel (K2) computes, in float32 [M,
    N]: per 128-K span (dot - sum(xq) * zero) * scale, summed over the
    k-block's spans, times the k-block's activation scale, summed over
    k-blocks. G = 128 makes the span the reference's group; at G = 256, ...
    the scale distributes over the group's spans. (The kernel adds the spans
    in order within each of its K slices, then the slices in order: another
    f32 order of the same sum.)"""
    return _w4a8_spans(x, qweight, scales, zeros, bits, block_k, rms_gamma, rms_eps, span_sx=False)


def plain_group(x, qweight, scales, zeros, bits, rms_gamma=None, rms_eps=1e-6):
    """What tile_kernel<group> computes, in float32 [M, N]. x is bf16."""
    if rms_gamma is not None:
        x = rms_prologue(x, rms_gamma, rms_eps)
    M, K, n_g, G, w = _group_operands(x, qweight, scales, bits)
    xg = x.float().reshape(M, n_g, G).transpose(0, 1)  # [n_g, M, G]
    dots = torch.bmm(xg, w)
    if zeros is not None:
        dots = dots - xg.sum(dim=2)[:, :, None] * zeros.float()[:, None, :]
    return (dots * scales.float()[:, None, :]).sum(dim=0)


def plain_dequant(x, qweight, scales, zeros, bits, rms_gamma=None, rms_eps=1e-6):
    """What tile_kernel<dequant> computes, in float32 [M, N]: the weight is
    (q - z) * s evaluated in bf16 (each step rounds), then one dot with f32
    sums. x is bf16."""
    if rms_gamma is not None:
        x = rms_prologue(x, rms_gamma, rms_eps)
    K = x.shape[1]
    n_g = scales.shape[0]
    wg = unpack_signed(qweight, bits).to(torch.bfloat16).T.reshape(n_g, K // n_g, -1)
    if zeros is not None:
        wg = wg - zeros.to(torch.bfloat16)[:, None, :]
    wd = wg * scales.to(torch.bfloat16)[:, None, :]
    return x.float() @ wd.reshape(K, -1).float()


def gemv_span(group_size: int) -> int:
    """K of one scaled dot of the gemv kernel: the group at G = 128 (and its
    128-K parts at G = 256, ...), else 32 K."""
    return 128 if group_size % 128 == 0 else 32


def plain_gemv(x, qweight, scales, zeros, bits, rms_gamma=None, rms_eps=1e-6):
    """What csrc/quant_gemv.cu:gemv_kernel computes, in float32 [M, N]: per
    span of K (gemv_span(G)) the f32 dot of x with the integer weights,
    (dot - sum(x) * zero) * scale, summed over the spans. x is bf16. (The
    kernel adds the spans in order within each of its K slices, then the
    slices in order: another f32 order of the same sum.)"""
    if rms_gamma is not None:
        x = rms_prologue(x, rms_gamma, rms_eps)
    M, K = x.shape
    G = K // scales.shape[0]
    span = gemv_span(G)
    n_sp = K // span
    w = unpack_signed(qweight, bits).float().T.reshape(n_sp, span, -1)  # [spans, span, N]
    xs = x.float().reshape(M, n_sp, span).transpose(0, 1)  # [spans, M, span]
    dots = torch.bmm(xs, w)
    per = G // span
    if zeros is not None:
        dots = dots - xs.sum(dim=2)[:, :, None] * zeros.float().repeat_interleave(per, 0)[:, None, :]
    return (dots * scales.float().repeat_interleave(per, 0)[:, None, :]).sum(dim=0)


def plain_w4a8g(x, qweight, scales, zeros, bits, block_k, rms_gamma=None, rms_eps=1e-6):
    """What csrc/quant_gemv.cu:w4a8g_kernel (K12b) computes, in float32 [M,
    N]: activations quantized as plain_w4a8 quantizes them; per 128-K span
    (dot - sum(xq) * zero) * scale * sx, summed over the spans."""
    return _w4a8_spans(x, qweight, scales, zeros, bits, block_k, rms_gamma, rms_eps, span_sx=True)


def plain_stream(x, qweight, scales, zeros, bits, block_k):
    """The stream probe's output, float32 [M, N] (every row the same): the
    reference's _stream_only_kernel touch, per k-block (first packed byte
    as int8) * (first scale row) (+ first zero row) + x[0, block start],
    summed over k-blocks in f32. As XLA evaluates the reference, the
    product and the addition after it round once (a fused multiply-add,
    exact here in float64 and then rounded); the rest rounds per step. x
    is bf16 (normed ahead where the call has an RMSNorm prologue)."""
    M, K = x.shape
    G = K // scales.shape[0]
    pack = 2 if bits == 4 else 1
    acc = torch.zeros(qweight.shape[0], dtype=torch.float32, device=x.device)
    for kb in range(K // block_k):
        k = kb * block_k
        qs = qweight[:, k // pack].double() * scales[k // G].double()
        if zeros is not None:
            t = (qs + zeros[k // G].double()).float() + x[0, k].float()
        else:
            t = (qs + x[0, k].double()).float()
        acc = acc + t
    return acc.expand(M, -1).contiguous()


# ---------------------------------------------------------------- dispatch


def _shrink_block_k(block_k: int, K: int, chunk: int) -> int:
    """Largest multiple of lcm(chunk, 128) that divides K and is <= block_k;
    K itself when K cannot be cut that way."""
    chunk = math.lcm(chunk, 128)
    if K % chunk == 0 and K > chunk:
        bk = (min(block_k, K) // chunk) * chunk
        while bk > chunk and K % bk != 0:
            bk -= chunk
        return max(bk, chunk)
    return K


def plan(
    M: int, K: int, N: int, bits: int, group_size: int, scales_itemsize: int,
    has_rms: bool, variant: str = "", block_k: int = 0, tile_n: int = DEFAULT_TILE_N,
) -> Tuple[str, int, bool]:
    """(variant, block_k, fuse_rms) as the reference's quant_matmul picks them
    for a weight in its tiled storage of width tile_n, which is what its
    models run. Only the decisions that change results are carried over:
    the variant; the k-block, which for W4A8 is the span of one activation
    scale; and whether the RMSNorm runs in the kernel's prologue. An
    explicit variant="group" stays `group` at any M, as on the reference's
    flat layout; an explicit "gemv" or "w4a8g" turns into `group` above
    M = 64 and, on the tiled storage, into `dequant`. "stream" (the probe)
    takes the k-block and prologue of the default variant, as the
    reference's probe takes over the body of whatever kernel the call runs."""
    G = group_size
    block_n = min(tile_n, N)
    if variant not in ("",) + VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant == "stream":
        _, bk, fuse_rms = plan(M, K, N, bits, G, scales_itemsize, has_rms,
                               block_k=block_k, tile_n=tile_n)
        return "stream", bk, fuse_rms
    forced_group = variant == "group"
    bk = block_k or 2048
    variant = variant or ("w4a8" if M <= 64 else "group")
    if G < 128 and variant in ("group", "w4a8", "w4a8g"):
        variant = "dequant"  # the reference's group reshape needs G >= 128 (gemv takes any G)
    chunk = (16 if scales_itemsize == 2 else 8) * G
    w_bytes_per_k = block_n // 2 if bits == 4 else block_n
    max_bk = max((4 * 1024 * 1024) // w_bytes_per_k, chunk)
    if scales_itemsize == 2 and K % chunk != 0 and K % (8 * G) == 0:
        chunk = 8 * G  # the reference upcasts the scales to f32 for such K
    if has_rms and M <= 64 and K <= max_bk and K % chunk == 0:
        bk = K  # the prologue's mean needs all of K in one k-block
    bk = _shrink_block_k(min(bk, max_bk), K, chunk)
    if bk < 1024 and bk < K <= max_bk:
        bk = K  # awkward K: one full-K block instead of many small ones
    if M > 64:
        if variant in ("gemv", "w4a8", "w4a8g"):
            variant = "group"
        if not (forced_group and variant == "group"):
            variant = "dequant"
            bk = _shrink_block_k(
                min(bk, max(4 * 1024 * 1024 // (block_n * 2), chunk)), K, chunk)
    fuse_rms = has_rms and K // bk == 1 and M <= 256
    return variant, bk, fuse_rms


def _run(plain: bool, x, qweight, scales, zeros, bits, symmetric, variant, block_k,
         rms_gamma, rms_eps, tile_n):
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    M, K = x.shape
    N = qweight.shape[0]
    if qweight.shape[1] * (2 if bits == 4 else 1) != K or scales.shape[1] != N:
        raise ValueError(
            f"x {tuple(x.shape)}, qweight {tuple(qweight.shape)} and scales "
            f"{tuple(scales.shape)} do not match for bits={bits}")
    if K % scales.shape[0]:
        raise ValueError(f"K={K} is not a multiple of its {scales.shape[0]} groups")
    G = K // scales.shape[0]
    if symmetric:
        zeros = None
    if variant == "ref":
        if not plain:
            raise ValueError('variant="ref" is the float reference, for CPU tensors only')
        if rms_gamma is not None:
            x = rms_prologue(x, rms_gamma, rms_eps)
        return ref_quant_matmul(x, qweight, scales, zeros, bits)
    variant, block_k, fuse_rms = plan(
        M, K, N, bits, G, scales.dtype.itemsize, rms_gamma is not None,
        variant=variant, block_k=block_k, tile_n=tile_n)
    if rms_gamma is not None and not fuse_rms:
        x = rms_prologue(x, rms_gamma, rms_eps)
        rms_gamma = None
    x_op = x.to(torch.bfloat16)
    args = (x_op, qweight, scales, zeros, bits)
    if variant == "stream":
        # The probe's prologue, fused or not, runs ahead of it on the bf16 x
        # that a fused prologue would read.
        if rms_gamma is not None:
            x_op = rms_prologue(x_op, rms_gamma, rms_eps)
        fn = plain_stream if plain else quant_stream_probe_cuda
        out = fn(x_op, qweight, scales, zeros, bits, block_k)
    elif variant in ("w4a8", "w4a8g"):  # the k-block is part of their function
        fn = dict(w4a8=(plain_w4a8, quant_matmul_w4a8_cuda),
                  w4a8g=(plain_w4a8g, quant_w4a8_gemv_cuda))[variant][0 if plain else 1]
        out = fn(*args, block_k, rms_gamma, rms_eps)
    else:
        fn = dict(group=(plain_group, quant_matmul_group_cuda),
                  dequant=(plain_dequant, quant_matmul_dequant_cuda),
                  gemv=(plain_gemv, quant_gemv_cuda))[variant][0 if plain else 1]
        out = fn(*args, rms_gamma, rms_eps)
    return out.to(x.dtype)


def quant_matmul(
    x: torch.Tensor,  # [M, K]
    qweight: torch.Tensor,  # kernel layout: int8 [N, K/2] (int4) or [N, K]
    scales: torch.Tensor,  # [K/G, N], f32 or bf16
    zeros: Optional[torch.Tensor] = None,  # int8 [K/G, N] (None => symmetric)
    bits: int = 4,
    symmetric: bool = False,
    variant: str = "",
    block_k: int = 0,
    rms_gamma: Optional[torch.Tensor] = None,  # [K]: fused RMSNorm prologue
    rms_eps: float = 1e-6,
    tile_n: int = DEFAULT_TILE_N,
) -> torch.Tensor:
    """x @ dequant(qweight) in x's type: the kernels for a CUDA tensor, the
    plain versions for a CPU tensor. rms_gamma asks for RMSNorm(x) first; it
    runs inside the kernel where plan() says so, before the call otherwise,
    with the same values either way."""
    return _run(x.device.type == "cpu", x, qweight, scales, zeros, bits, symmetric,
                variant, block_k, rms_gamma, rms_eps, tile_n)


def plain_quant_matmul(
    x, qweight, scales, zeros=None, bits=4, symmetric=False, variant="", block_k=0,
    rms_gamma=None, rms_eps=1e-6, tile_n=DEFAULT_TILE_N,
) -> torch.Tensor:
    """quant_matmul with the same decisions but always the plain versions, on
    whatever device x lies: what the kernels are held against on the card."""
    return _run(True, x, qweight, scales, zeros, bits, symmetric, variant, block_k,
                rms_gamma, rms_eps, tile_n)


# ---------------------------------------------------------------- CUDA wrappers

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Parameters of the C entry points of csrc/quant_matmul.cu, in order.
# w4a8 (and csrc/quant_gemv.cu's w4a8g): x, qweight, scales, zeros,
# rms_gamma, xq, xs, out; M, K, N, group_size, bits, scales_bf16,
# gamma_bf16, block_k, k_slices; rms_eps; stream.
_W4A8_ARGTYPES = [_P] * 8 + [_I] * 9 + [_F, _P]
# group and dequant: x, qweight, scales, zeros, rms_gamma, xn, xsum, out; M,
# K, N, group_size, bits, scales_bf16, gamma_bf16, tile; rms_eps; stream.
_TILE_ARGTYPES = [_P] * 8 + [_I] * 8 + [_F, _P]
ENTRY_POINTS = {
    "scalellm_quant_matmul_w4a8": _W4A8_ARGTYPES,
    "scalellm_quant_matmul_group": _TILE_ARGTYPES,
    "scalellm_quant_matmul_dequant": _TILE_ARGTYPES,
}
W4A8_MAX_M = 64
W4A8_MAX_K = 32 * 1024  # the activation kernel stages a row of x and xq in shared memory


def _library() -> ctypes.CDLL:
    lib = _build.load("quant_matmul")
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check_cuda_operands(x, qweight, scales, zeros, bits, rms_gamma):
    """Raise on what the kernels do not take; returns (M, K, N, G)."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"the CUDA kernels take bf16 x, got {x.dtype}")
    if qweight.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"qweight must be int8 or uint8, got {qweight.dtype}")
    if scales.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"scales must be f32 or bf16, got {scales.dtype}")
    if zeros is not None and (zeros.dtype != torch.int8 or zeros.shape != scales.shape):
        raise ValueError("zeros must be int8 of the scales' shape")
    if rms_gamma is not None and rms_gamma.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"rms_gamma must be f32 or bf16, got {rms_gamma.dtype}")
    M, K = x.shape
    N = qweight.shape[0]
    for name, t in (("x", x), ("qweight", qweight), ("scales", scales), ("zeros", zeros),
                    ("rms_gamma", rms_gamma)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rms_gamma is not None and rms_gamma.shape != (K,):
        raise ValueError(f"rms_gamma must be [{K}], got {tuple(rms_gamma.shape)}")
    if bits not in (4, 8) or qweight.shape[1] * (2 if bits == 4 else 1) != K:
        raise ValueError(f"qweight {tuple(qweight.shape)} does not match K={K}, bits={bits}")
    if scales.shape[1] != N or K % scales.shape[0]:
        raise ValueError(f"scales {tuple(scales.shape)} do not match K={K}, N={N}")
    return M, K, N, K // scales.shape[0]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _is_bf16(t: Optional[torch.Tensor]) -> int:
    return int(t is not None and t.dtype == torch.bfloat16)


def quant_matmul_w4a8_cuda(x, qweight, scales, zeros, bits, block_k,
                           rms_gamma=None, rms_eps=1e-6) -> torch.Tensor:
    """Launch the W4A8 kernel (K2: activation quantization, then the int8
    matmul on the integer small-M mainloop, one C call) on the current
    stream; returns bf16 [M, N]. `quant_matmul_w4a8_cuda.launches` counts the
    launches."""
    out = _w4a8_cuda(_library, "scalellm_quant_matmul_w4a8", "w4a8", x, qweight, scales, zeros, bits,
                     block_k, rms_gamma, rms_eps)
    quant_matmul_w4a8_cuda.launches += 1
    return out


quant_matmul_w4a8_cuda.launches = 0


# The tile kernel's block shapes, (weight rows, tokens), in the order of
# csrc/quant_matmul.cu:launch_tile_bits, and those each variant takes above
# M = 64 (group has no 192-row tile: its second accumulator).
TILES = ((64, 32), (64, 64), (128, 64), (128, 128), (192, 128))
LARGE_TILES = {"dequant": (4, 3, 2, 1), "group": (3, 2, 1)}
# Time per output element of a full wave of blocks, relative to (128, 128),
# from an H100's timings of each tile at the 8B gate_up projection: a
# smaller token tile unpacks each weight for fewer tokens.
TILE_COST = (2.5, 2.0, 1.45, 1.0, 0.9)


def tile_shape(variant: str, M: int, K: int, N: int, G: int, sms: int = 132) -> int:
    """The tile kernel's block shape for a call (an index into TILES): the
    token tile from M (32 or 64 up to M = 64); above that the shape whose
    grid takes the least time: waves of `sms` blocks, times the tile's size
    and its TILE_COST (the larger tile on a tie: fewer bytes through L2).
    Raises NotImplementedError on what the kernel does not take."""
    if K % 32 or N % 2 or K % G or G % 32 or -(-N // 64) > 65535:
        raise NotImplementedError(
            f"the {variant} kernel needs K % 32 == 0, G % 32 == 0, even N <= 64 * 65535; "
            f"got K={K}, N={N}, G={G}")
    if M <= 32:
        return 0
    if M <= 64:
        return 1

    def cost(i):
        rows, toks = TILES[i]
        blocks = -(-M // toks) * -(-N // rows)
        return (-(-blocks // sms) * rows * toks * TILE_COST[i], -rows * toks)

    return min(LARGE_TILES[variant], key=cost)


def _tile_cuda(entry: str, x, qweight, scales, zeros, bits, rms_gamma, rms_eps):
    M, K, N, G = _check_cuda_operands(x, qweight, scales, zeros, bits, rms_gamma)
    if x.data_ptr() % 16 or qweight.data_ptr() % 16:
        raise NotImplementedError(f"the {entry} kernel loads x and qweight by TMA: 16-byte aligned starts")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile = tile_shape(entry, M, K, N, G, sms)
    dev = x.device
    out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    # Scratch of the pre-pass: the normed x, and group's sums of x per 32-K span.
    xn = torch.empty(M, K, dtype=torch.bfloat16, device=dev) if rms_gamma is not None else None
    xsum = (torch.empty(K // 32, M, dtype=torch.float32, device=dev)
            if entry == "group" and zeros is not None else None)
    rc = getattr(_library(), "scalellm_quant_matmul_" + entry)(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _ptr(zeros), _ptr(rms_gamma),
        _ptr(xn), _ptr(xsum), out.data_ptr(), M, K, N, G, bits, _is_bf16(scales),
        _is_bf16(rms_gamma), tile, float(rms_eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_matmul {entry} kernel launch failed: CUDA error {rc}")
    return out


def quant_matmul_group_cuda(x, qweight, scales, zeros, bits,
                            rms_gamma=None, rms_eps=1e-6) -> torch.Tensor:
    """Launch the group kernel on the current stream; returns bf16 [M, N].
    `quant_matmul_group_cuda.launches` counts the launches."""
    out = _tile_cuda("group", x, qweight, scales, zeros, bits, rms_gamma, rms_eps)
    quant_matmul_group_cuda.launches += 1
    return out


quant_matmul_group_cuda.launches = 0


def quant_matmul_dequant_cuda(x, qweight, scales, zeros, bits,
                              rms_gamma=None, rms_eps=1e-6) -> torch.Tensor:
    """Launch the dequant kernel on the current stream; returns bf16 [M, N].
    `quant_matmul_dequant_cuda.launches` counts the launches."""
    out = _tile_cuda("dequant", x, qweight, scales, zeros, bits, rms_gamma, rms_eps)
    quant_matmul_dequant_cuda.launches += 1
    return out


quant_matmul_dequant_cuda.launches = 0


# ---------------------------------------------------------------- small-M variants and the probe
#
# csrc/quant_gemv.cu: gemv (K12a, on the tensor-core mainloop of
# csrc/quant_small_m.cuh), w4a8g (K12b, on its integer mainloop, with K2),
# the stream probe (K12c).

# gemv: x, qweight, scales, zeros, rms_gamma, xn, xsum, out; M, K, N,
# group_size, bits, scales_bf16, gamma_bf16, k_slices; rms_eps; stream.
# w4a8g: as w4a8 (_W4A8_ARGTYPES).
# stream probe: x, qweight, scales, zeros, sink, out; M, K, N, group_size,
# bits, scales_bf16, block_k, weights_only, blocks; stream.
GEMV_ENTRY_POINTS = {
    "scalellm_quant_gemv": [_P] * 8 + [_I] * 8 + [_F, _P],
    "scalellm_quant_w4a8_gemv": _W4A8_ARGTYPES,
    "scalellm_quant_stream_probe": [_P] * 6 + [_I] * 9 + [_P],
}
SMALL_M_ROWS = 128  # weight rows of a small-M mainloop block with one K slice (8 warps x 16)
SMALL_M_MAX_SLICES = 4
STREAM_THREADS = 256  # threads of a probe block, one sink word a warp
STREAM_LOADS = 8  # 16-byte loads a probe thread keeps in flight


def _gemv_library() -> ctypes.CDLL:
    lib = _build.load("quant_gemv")
    for name, argtypes in GEMV_ENTRY_POINTS.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def small_m_slices(N: int, sms: int) -> int:
    """K slices of a block of the small-M mainloop (gemv, and K11's down)
    for N output columns: 1 (a block owns 128 columns over all of K; gemv
    then takes 64-128 so that the SMs share N evenly) where that gives at
    least 0.9 of a block an SM, else 2 or 4 (64 or 32 columns a block, its
    8 warps splitting K, their sums added in slice order)."""
    ks = 1
    while ks < SMALL_M_MAX_SLICES and -(-N // (SMALL_M_ROWS // ks)) < 0.9 * sms:
        ks *= 2
    return ks


def small_m_pad(M: int) -> int:
    """M padded to the token tiles of the small-M mainloop: 8, 16, 32 or 64
    (the row length of its staged sums of x)."""
    return 8 if M <= 8 else 16 if M <= 16 else 32 if M <= 32 else 64


def _check_small_m(name, M, K, G, g_mult):
    if M > W4A8_MAX_M:
        raise NotImplementedError(f"the {name} kernel takes M <= {W4A8_MAX_M}, got {M}")
    if G % g_mult or K % 128:
        raise NotImplementedError(
            f"the {name} kernel needs G % {g_mult} == 0 and K % 128 == 0; got K={K}, G={G}")


def check_w4a8(name: str, M: int, K: int, G: int, block_k: int) -> None:
    """Raise on what the W4A8 kernels (w4a8, w4a8g) do not take: M > 64, G
    not a multiple of 128 (a span of the integer mainloop lies inside one
    group; int8 weights at G = 64, which the first K2 took, are refused), K
    past 32768 (the pre-pass holds a row in shared memory); a block_k that
    is no multiple of G dividing K is a ValueError."""
    _check_small_m(name, M, K, G, W4A8_SPAN)
    if K > W4A8_MAX_K:
        raise NotImplementedError(f"the {name} kernel takes K <= {W4A8_MAX_K}, got {K}")
    if block_k <= 0 or block_k % G or K % block_k:
        raise ValueError(f"block_k={block_k} must be a multiple of G={G} that divides K={K}")


def _w4a8_cuda(library, entry, name, x, qweight, scales, zeros, bits, block_k, rms_gamma, rms_eps):
    """One C call of a W4A8 kernel (K2's or K12b's entry point of the library
    `library()` loads): its pre-pass and the integer mainloop; returns bf16
    [M, N]."""
    M, K, N, G = _check_cuda_operands(x, qweight, scales, zeros, bits, rms_gamma)
    check_w4a8(name, M, K, G, block_k)
    if x.data_ptr() % 16 or qweight.data_ptr() % 16:
        raise NotImplementedError(f"the {name} kernel loads x and qweight in 16-byte pieces: 16-byte aligned starts")
    dev = x.device
    slices = small_m_slices(N, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    # Scratch of the pre-pass, in the layout of the ring's stages, M padded to
    # the token tiles: xq in 32-K pieces, and per 128-K span the sums of xq
    # (int32) and the activation scales.
    pad = small_m_pad(M)
    xq = torch.empty(K // 32, pad, 32, dtype=torch.int8, device=dev)
    xs = torch.empty(K // W4A8_SPAN * 2, pad, dtype=torch.float32, device=dev)
    rc = getattr(library(), entry)(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _ptr(zeros), _ptr(rms_gamma),
        xq.data_ptr(), xs.data_ptr(), out.data_ptr(), M, K, N, G, bits, _is_bf16(scales),
        _is_bf16(rms_gamma), block_k, slices, float(rms_eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_matmul {name} kernel launch failed: CUDA error {rc}")
    return out


def quant_gemv_cuda(x, qweight, scales, zeros, bits, rms_gamma=None, rms_eps=1e-6) -> torch.Tensor:
    """Launch the gemv kernel (K12a; its pre-pass for the RMSNorm prologue
    and the sums of x, where the call has them, in the same C call) on the
    current stream; returns bf16 [M, N]. `quant_gemv_cuda.launches` counts
    the launches."""
    M, K, N, G = _check_cuda_operands(x, qweight, scales, zeros, bits, rms_gamma)
    _check_small_m("gemv", M, K, G, 32)
    if x.data_ptr() % 16 or qweight.data_ptr() % 16:
        raise NotImplementedError("the gemv kernel loads x and qweight by TMA: 16-byte aligned starts")
    dev = x.device
    slices = small_m_slices(N, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    # Scratch of the pre-pass: the normed x, and the sums of x per span.
    xn = torch.empty(M, K, dtype=torch.bfloat16, device=dev) if rms_gamma is not None else None
    xsum = (torch.empty(K // gemv_span(G), small_m_pad(M), dtype=torch.float32, device=dev)
            if zeros is not None else None)
    rc = _gemv_library().scalellm_quant_gemv(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _ptr(zeros), _ptr(rms_gamma),
        _ptr(xn), _ptr(xsum), out.data_ptr(), M, K, N, G, bits, _is_bf16(scales),
        _is_bf16(rms_gamma), slices, float(rms_eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_matmul gemv kernel launch failed: CUDA error {rc}")
    quant_gemv_cuda.launches += 1
    return out


quant_gemv_cuda.launches = 0


def quant_w4a8_gemv_cuda(x, qweight, scales, zeros, bits, block_k,
                         rms_gamma=None, rms_eps=1e-6) -> torch.Tensor:
    """Launch the w4a8g kernel (K12b: activation quantization, then the int8
    matmul on the integer small-M mainloop with each span's own activation
    scale, one C call) on the current stream; returns bf16 [M, N].
    `quant_w4a8_gemv_cuda.launches` counts the launches."""
    out = _w4a8_cuda(_gemv_library, "scalellm_quant_w4a8_gemv", "w4a8g", x, qweight, scales, zeros, bits,
                     block_k, rms_gamma, rms_eps)
    quant_w4a8_gemv_cuda.launches += 1
    return out


quant_w4a8_gemv_cuda.launches = 0


def quant_stream_probe_cuda(x, qweight, scales, zeros, bits, block_k,
                            weights_only=False) -> torch.Tensor:
    """Launch the weight-stream probe (K12c) on the current stream: every
    byte of qweight, scales (not with weights_only) and zeros is read; the
    bf16 [M, N] output is plain_stream's touch (not a matmul; with
    weights_only it reads scale 1). `quant_stream_probe_cuda.launches`
    counts the launches."""
    M, K, N, G = _check_cuda_operands(x, qweight, scales, zeros, bits, None)
    if block_k <= 0 or block_k % G or K % block_k:
        raise ValueError(f"block_k={block_k} must be a multiple of G={G} that divides K={K}")
    if qweight.data_ptr() % 16 or scales.data_ptr() % 4 or (zeros is not None and zeros.data_ptr() % 4):
        raise NotImplementedError("the stream probe reads qweight in 16-byte and scales/zeros in 4-byte words")
    # The grid: at most 4 blocks an SM, fewer where the weights give each
    # thread fewer than its loads in flight.
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(4 * sms, qweight.numel() // (16 * STREAM_THREADS * STREAM_LOADS)))
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    sink = torch.empty(blocks * STREAM_THREADS // 32, dtype=torch.int32, device=x.device)
    rc = _gemv_library().scalellm_quant_stream_probe(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _ptr(zeros), sink.data_ptr(),
        out.data_ptr(), M, K, N, G, bits, _is_bf16(scales), block_k, int(weights_only), blocks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_matmul stream probe launch failed: CUDA error {rc}")
    quant_stream_probe_cuda.launches += 1
    return out


quant_stream_probe_cuda.launches = 0
