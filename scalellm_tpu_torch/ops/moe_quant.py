"""Quantized routed-expert matmuls (K7, K8): the expert quantizers, the float
reference, the kernels' plain versions, the CUDA kernels' wrappers and the
dispatcher.

Counterpart of scalellm_tpu/ops/moe_quant.py. Rows of xs [R, K] belong to
experts: expert e owns rows [starts[e], starts[e] + group_sizes[e]), where
starts is the exclusive cumsum of group_sizes after the sort-by-expert
dispatch, or given explicitly by the T=1 layout (row j is top-k slot j's
expert, rows unsorted). Each row is multiplied by its expert's dequantized
weight; the result is f32 [R, N], 0 on rows outside every group.

Storage of one projection's E experts (the port's layout):
  int4  qweight int8 [E, N, K/2]: per expert the reference's packed [K/2, N]
        bytes transposed (ops/quant_matmul.py's kernel layout), byte j of a
        row holding K=2j in bits 0-3 and K=2j+1 in bits 4-7 as signed
        nibbles; scales bf16 [E, K/G, N] (as the reference's).
  int8  qweight int8 [E, N, K]; scales f32 [E, N] (as the reference's).
Why [E, N, K]: torch's [out, in] per expert, as the bf16 experts of K6 are
stored, and K-contiguous, so 16 bytes of a row are 32 (int4) or 16 (int8)
consecutive K of one output column, the tensor core's B fragment.

Dispatch (the reference's decisions):
  - rows <= 256 and the TPU kernel's VMEM budget (fits_decode_kernel, kept
    because it decides which numerics an int4 call gets): K7 (one
    projection) or K8 (gate and up in one launch), over the active experts.
    int4: per-span f32 dots (a span is the group at G = 128) times the
    group's scale; int8: the whole-K dot times the channel scale.
  - otherwise the experts are dequantized to bf16 (int4: q * s in f32,
    rounded once, in natural K order, by csrc/expert_dequant.cu on the card;
    int8: q cast) and run through K6 (ops/grouped_matmul.py), then int8 rows
    are multiplied by their expert's channel scales. K6 needs expert-sorted
    rows, so an explicit starts/active layout raises there.
  - the pair takes K8 whenever gate and up have the same shapes and the
    decode kernel fits; else two single calls, with the same values. The
    reference's separate 12 MB VMEM budget for the pair is a limit of the
    TPU's fast memory that does not change results, so it is not carried
    over.
variant="" runs the kernels on a CUDA tensor and their plain versions on a
CPU tensor; "plain" the plain versions on any device (what the kernels are
held against on the card); "ref" the float reference the JAX package
computes on the CPU (CPU tensors only).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul_cuda, plain_grouped_matmul

# The reference's decode-kernel limits: rows, and its VMEM budget.
DECODE_MAX_ROWS = 256
DECODE_VMEM_BYTES = 12 * 1024 * 1024
VARIANTS = ("", "plain", "ref")

# ---------------------------------------------------------------- quantizers


def quantize_experts_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[E, N, K] float -> (int8 [E, N, K], f32 scales [E, N]): symmetric per
    (expert, output channel), as the reference's quantize_experts_int8."""
    wf = w.to(torch.float32, copy=True)
    scales = wf.abs().amax(dim=2).clamp_min(1e-8) / 127.0
    q = wf.div_(scales[:, :, None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, scales


def quantize_experts_int4(w: torch.Tensor, group_size: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """[E, N, K] float -> (packed int8 [E, N, K/2], bf16 scales [E, K/G, N]):
    symmetric per (expert, k-group, output channel), as the reference's
    quantize_experts_int4. The scale goes through bf16 before the grid is
    built, so the stored scale is the one the grid was built against."""
    E, N, K = w.shape
    if K % group_size:
        raise ValueError(f"K={K} is not a multiple of the group size {group_size}")
    g = w.to(torch.float32, copy=True).view(E, N, K // group_size, group_size)
    absmax = g.abs().amax(dim=3).clamp_min(1e-8)  # [E, N, K/G]
    scales = torch.clamp(absmax / 7.0, min=1e-10).to(torch.bfloat16)
    q = g.div_(scales.float()[..., None]).round_().clamp_(-8, 7).to(torch.int8).view(E, N, K)
    packed = (q[..., 0::2] & 0xF) | (q[..., 1::2] << 4)
    return packed, scales.transpose(1, 2).contiguous()


def expert_bits(K: int, qweight: torch.Tensor) -> int:
    """4 or 8, from xs's K against the stored row width of qweight."""
    Kw = qweight.shape[-1]
    if Kw * 2 == K:
        return 4
    if Kw == K:
        return 8
    raise ValueError(f"qweight {tuple(qweight.shape)} matches neither int4 nor int8 at K={K}")


def unpack_experts(qweight: torch.Tensor) -> torch.Tensor:
    """Packed int4 [..., K/2] -> the signed weights, int8 [..., K]."""
    lo = ((qweight & 0xF) ^ 8) - 8
    hi = qweight >> 4  # arithmetic shift: the high nibble, sign-extended
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def dequantize_experts(qweight: torch.Tensor, scales: torch.Tensor, K: int) -> torch.Tensor:
    """The experts' weights in f32, [E, N, K]: q * s per group (int4) or per
    channel (int8)."""
    if expert_bits(K, qweight) == 8:
        return qweight.float() * scales.float()[:, :, None]
    E, N, _ = qweight.shape
    n_g = scales.shape[1]
    q = unpack_experts(qweight).float().view(E, N, n_g, K // n_g)
    return (q * scales.float().transpose(1, 2)[..., None]).view(E, N, K)


def plain_dequantize_experts_bf16(qweight: torch.Tensor, scales: torch.Tensor, K: int) -> torch.Tensor:
    """The bf16 weights [E, N, K] the grouped GEMM takes on steps too large
    for the decode kernel, as the reference's TPU path makes them: int4 q * s
    in f32 rounded once to bf16 (q * s is exact in f32), in natural K order;
    int8 q cast exactly (its channel scale comes after the product)."""
    if expert_bits(K, qweight) == 8:
        return qweight.to(torch.bfloat16)
    return dequantize_experts(qweight, scales, K).to(torch.bfloat16)


def dequantize_experts_bf16(qweight: torch.Tensor, scales: torch.Tensor, K: int, plain: bool = False) -> torch.Tensor:
    """plain_dequantize_experts_bf16's weights: int4 on a CUDA tensor through
    the kernel of csrc/expert_dequant.cu (the same bits), on a CPU tensor or
    with `plain` through the plain version; int8 by one cast."""
    if plain or qweight.device.type == "cpu" or expert_bits(K, qweight) == 8:
        return plain_dequantize_experts_bf16(qweight, scales, K)
    return expert_dequant_cuda(qweight, scales, K)


# ---------------------------------------------------------------- device-side layout


def expert_starts(group_sizes: torch.Tensor) -> torch.Tensor:
    """The first row of each expert after the sort-by-expert dispatch: the
    exclusive cumsum of group_sizes, i32[E], on the device."""
    return (torch.cumsum(group_sizes, 0) - group_sizes).to(torch.int32)


def active_experts(group_sizes: torch.Tensor, max_active: int = 0) -> torch.Tensor:
    """The experts with rows, in id order, padded with -1 to min(E,
    max_active) slots (E when max_active is 0): i32, on the device, with no
    host sync (a stable sort where the reference takes jnp.nonzero with a
    fixed size)."""
    E = group_sizes.shape[0]
    A = min(E, max_active) if max_active else E
    has_rows = group_sizes > 0
    order = torch.argsort((~has_rows).to(torch.int8), stable=True)
    return torch.where(has_rows[order], order, -1)[:A].to(torch.int32)


def fits_decode_kernel(Tp: int, K: int, qweight_shape: Sequence[int], scales_shape: Sequence[int],
                       scales_itemsize: int = 2) -> bool:
    """The reference's gate for its decode kernel, a function of shapes: Tp
    rows at most 256 and the TPU kernel's VMEM footprint (double-buffered
    weight tiles, the scales it keeps, the activations and the f32 output)
    at most 12 MB. It decides whether int4 experts get per-group dots or
    bf16-rounded weights, so the port takes it as it is."""
    E, N, Kw = qweight_shape[-3:]
    bits = 4 if Kw * 2 == K else 8
    if bits == 4 and scales_shape[-2] % 8 == 0:
        n_scale = 2 * scales_shape[-2] * N
    elif bits == 4:
        n_scale = E * scales_shape[-2] * N
    else:
        n_scale = E * N
    decode_vmem = (
        2 * Kw * N  # int8 weight ring
        + n_scale * (scales_itemsize if bits == 4 else 4)
        + Tp * K * 2  # bf16 activations
        + Tp * N * 4  # f32 output
    )
    return Tp <= DECODE_MAX_ROWS and decode_vmem <= DECODE_VMEM_BYTES


def takes_decode_kernel(R: int, K: int, qweight: torch.Tensor, scales: torch.Tensor) -> bool:
    """Whether R routed rows of width K take the decode kernel against these
    experts: fits_decode_kernel on R rounded up to 8, the row count the
    reference's gate sees (on a TPU it pads a decode-sized step's rows to a
    multiple of 8 first)."""
    return fits_decode_kernel(-(-R // 8) * 8, K, qweight.shape, scales.shape, scales.element_size())


# ---------------------------------------------------------------- plain versions


def ref_grouped_quant_matmul(xs: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                             group_sizes: torch.Tensor, starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The float reference (what the JAX package computes on the CPU): xs in
    f32 times every expert's f32 weights, masked to the expert's rows and
    summed, f32 [R, N]."""
    R, K = xs.shape
    w = dequantize_experts(qweight, scales, K)
    if starts is None:
        starts = expert_starts(group_sizes)
    ends = starts + group_sizes
    rows = torch.arange(R, device=xs.device)[:, None]
    xf = xs.float()
    out = torch.zeros(R, qweight.shape[1], dtype=torch.float32, device=xs.device)
    for e in range(qweight.shape[0]):
        mask = ((rows >= starts[e]) & (rows < ends[e])).float()
        out = out + mask * (xf @ w[e].T)
    return out


def fold_span(bits: int, G: int) -> int:
    """The K of one f32 dot the kernels fold into a row's sum: int4 128
    where G % 128 == 0 (one group at G = 128), else 32; int8 128 (its
    channel scale comes after the whole-K sum)."""
    return 128 if bits == 8 or G % 128 == 0 else 32


def _plain_rows(xs, qweight, scales, lo, hi, e, bits):
    """What the kernel computes for rows [lo, hi) of expert e, f32: the f32
    dot of each span of K (fold_span; a last span past K is short), int4
    times the span's group scale, added in span order; int8's sum times the
    channel scale."""
    x = xs[lo:hi].to(torch.bfloat16).float()
    K = xs.shape[1]
    q = (qweight[e] if bits == 8 else unpack_experts(qweight[e])).float()  # [N, K]
    G = K // scales.shape[1] if bits == 4 else K
    span = fold_span(bits, G)
    n_sp = -(-K // span)
    pad = n_sp * span - K
    x, q = torch.nn.functional.pad(x, (0, pad)), torch.nn.functional.pad(q, (0, pad))
    dots = torch.bmm(x.view(-1, n_sp, span).transpose(0, 1), q.view(-1, n_sp, span).permute(1, 2, 0))
    y = torch.zeros_like(dots[0])
    if bits == 8:
        for sp in range(n_sp):  # the spans in order, as the kernel adds them
            y += dots[sp]
        return y * scales[e].float()
    s = scales[e].float()
    for sp in range(n_sp):
        y += dots[sp] * s[sp * span // G]
    return y


def plain_grouped_quant_matmul(xs: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                               group_sizes: torch.Tensor, active: Optional[torch.Tensor] = None,
                               starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What csrc/moe_quant.cu's K7 computes, f32 [R, N]: for each active
    expert (every expert with rows when active is None), its rows of xs
    (bf16) times its weights, int4 as f32 dots over spans of K (one group
    at G = 128) times the span's group scale summed in span order, int8 as
    the whole-K dot times the channel scale; 0 on rows outside every
    group."""
    R, K = xs.shape
    bits = expert_bits(K, qweight)
    E = qweight.shape[0]
    if starts is None:
        starts = expert_starts(group_sizes)
    sizes, starts = group_sizes.tolist(), starts.tolist()
    experts = range(E) if active is None else [e for e in active.tolist() if 0 <= e < E]
    out = torch.zeros(R, qweight.shape[1], dtype=torch.float32, device=xs.device)
    for e in experts:
        lo, hi = max(starts[e], 0), min(starts[e] + max(sizes[e], 0), R)
        if hi > lo:
            out[lo:hi] += _plain_rows(xs, qweight, scales, lo, hi, e, bits)
    return out


def plain_grouped_quant_matmul_pair(xs, qweight_gate, scales_gate, qweight_up, scales_up, group_sizes,
                                    active=None, starts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K8 computes: K7 for gate and up."""
    return (plain_grouped_quant_matmul(xs, qweight_gate, scales_gate, group_sizes, active, starts),
            plain_grouped_quant_matmul(xs, qweight_up, scales_up, group_sizes, active, starts))


# ---------------------------------------------------------------- dispatch


def _use_plain(xs: torch.Tensor, variant: str) -> bool:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if variant == "ref" and xs.device.type != "cpu":
        raise ValueError('variant="ref" is the float reference, for CPU tensors only')
    return variant == "plain" or xs.device.type == "cpu"


def _layout(group_sizes, active, starts, max_active):
    """active and starts as given, else those of the sort-by-expert layout."""
    if active is None:
        active = active_experts(group_sizes, max_active)
    if starts is None:
        starts = expert_starts(group_sizes)
    return active, starts


def _dequant_grouped(plain, xs, qweight, scales, group_sizes, active, starts):
    """The reference's path for more rows than the decode kernel takes: the
    experts dequantized to bf16, K6, and int8's per-row channel scale."""
    if active is not None or starts is not None:
        raise ValueError("an explicit active/starts layout needs the decode kernel: the grouped GEMM "
                         f"takes expert-sorted rows only (got {xs.shape[0]} rows)")
    R, K = xs.shape
    gmm = plain_grouped_matmul if plain else grouped_matmul_cuda
    y = gmm(xs.to(torch.bfloat16).contiguous(), dequantize_experts_bf16(qweight, scales, K, plain), group_sizes)
    rows = torch.arange(R, device=xs.device)
    if expert_bits(K, qweight) == 8:
        e_of_row = torch.searchsorted(torch.cumsum(group_sizes, 0), rows, right=True)
        y = y * scales.float()[e_of_row.clamp_max(qweight.shape[0] - 1)]
    # K6 leaves rows past the last group unwritten.
    return torch.where((rows < group_sizes.sum())[:, None], y, 0.0)


def grouped_quant_matmul(xs: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                         group_sizes: torch.Tensor, *, active: Optional[torch.Tensor] = None,
                         starts: Optional[torch.Tensor] = None, max_active: int = 0,
                         variant: str = "") -> torch.Tensor:
    """xs [R, K] -> f32 [R, N] through the experts' quantized weights (module
    docstring). active (i32, -1 padded) and starts (i32[E]) default to the
    sort-by-expert layout of group_sizes; max_active caps the active slots
    (min(E, rows), the most experts the rows can reach)."""
    plain = _use_plain(xs, variant)
    if variant == "ref":
        return ref_grouped_quant_matmul(xs, qweight, scales, group_sizes, starts)
    R, K = xs.shape
    if not takes_decode_kernel(R, K, qweight, scales):
        return _dequant_grouped(plain, xs, qweight, scales, group_sizes, active, starts)
    active, starts = _layout(group_sizes, active, starts, max_active)
    if plain:
        return plain_grouped_quant_matmul(xs, qweight, scales, group_sizes, active, starts)
    return grouped_quant_matmul_cuda(xs.to(torch.bfloat16).contiguous(), qweight, scales, group_sizes,
                                     active, starts)


def grouped_quant_matmul_pair(xs: torch.Tensor, qweight_gate: torch.Tensor, scales_gate: torch.Tensor,
                              qweight_up: torch.Tensor, scales_up: torch.Tensor, group_sizes: torch.Tensor,
                              *, active: Optional[torch.Tensor] = None, starts: Optional[torch.Tensor] = None,
                              max_active: int = 0, variant: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate and up of the same rows: (g, u), each f32 [R, N]. K8 when the two
    have the same shapes and the decode kernel fits, else two
    grouped_quant_matmul calls (the same values either way)."""
    plain = _use_plain(xs, variant)
    R, K = xs.shape
    fused = (variant != "ref" and qweight_gate.shape == qweight_up.shape
             and scales_gate.shape == scales_up.shape and scales_gate.dtype == scales_up.dtype
             and takes_decode_kernel(R, K, qweight_gate, scales_gate))
    if not fused:
        kw = dict(active=active, starts=starts, max_active=max_active, variant=variant)
        return (grouped_quant_matmul(xs, qweight_gate, scales_gate, group_sizes, **kw),
                grouped_quant_matmul(xs, qweight_up, scales_up, group_sizes, **kw))
    active, starts = _layout(group_sizes, active, starts, max_active)
    if plain:
        return plain_grouped_quant_matmul_pair(xs, qweight_gate, scales_gate, qweight_up, scales_up,
                                               group_sizes, active, starts)
    return grouped_quant_matmul_pair_cuda(xs.to(torch.bfloat16).contiguous(), qweight_gate, scales_gate,
                                          qweight_up, scales_up, group_sizes, active, starts)


# ---------------------------------------------------------------- CUDA wrappers

_P, _I = ctypes.c_void_p, ctypes.c_int
# Parameters of the C entry points of csrc/moe_quant.cu, in order.
# decode: xs, qweight, scales, active, starts, sizes, out; R, K, N, E, A, G,
# bits; stream. pair: xs, qweight_gate, scales_gate, qweight_up, scales_up,
# active, starts, sizes, out_gate, out_up; R, K, N, E, A, G, bits; stream.
ENTRY_POINTS = {
    "scalellm_moe_quant_decode": [_P] * 7 + [_I] * 7 + [_P],
    "scalellm_moe_quant_decode_pair": [_P] * 10 + [_I] * 7 + [_P],
}


def _library() -> ctypes.CDLL:
    lib = _build.load("moe_quant")
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check_cuda_operands(xs, weights, group_sizes, active, starts):
    """Raise on what the kernels do not take; returns (R, K, N, E, G, bits)."""
    if xs.device.type != "cuda":
        raise ValueError(f"xs must be a CUDA tensor, got {xs.device}")
    if xs.dim() != 2 or xs.dtype != torch.bfloat16:
        raise NotImplementedError(f"the kernels take bf16 xs [R, K], got {xs.dtype} {tuple(xs.shape)}")
    R, K = xs.shape
    qweight, scales = weights[0]
    E, N, _ = qweight.shape
    bits = expert_bits(K, qweight)
    for qw, sc in weights:
        if qw.dtype not in (torch.int8, torch.uint8) or qw.shape != qweight.shape:
            raise ValueError(f"qweight must be int8 {tuple(qweight.shape)}, got {qw.dtype} {tuple(qw.shape)}")
        if bits == 4 and (sc.dtype != torch.bfloat16 or sc.dim() != 3 or sc.shape[0] != E
                          or sc.shape[2] != N or K % sc.shape[1]):
            raise ValueError(f"int4 scales must be bf16 [E, K/G, N], got {sc.dtype} {tuple(sc.shape)}")
        if bits == 8 and (sc.dtype != torch.float32 or tuple(sc.shape) != (E, N)):
            raise ValueError(f"int8 scales must be f32 [E, N], got {sc.dtype} {tuple(sc.shape)}")
    for name, t in (("group_sizes", group_sizes), ("starts", starts)):
        if t.dtype != torch.int32 or tuple(t.shape) != (E,):
            raise ValueError(f"{name} must be int32 [{E}], got {t.dtype} {tuple(t.shape)}")
    if active.dtype != torch.int32 or active.dim() != 1:
        raise ValueError(f"active must be a 1-D int32 tensor, got {active.dtype} {tuple(active.shape)}")
    tensors = [("xs", xs), ("group_sizes", group_sizes), ("starts", starts), ("active", active)]
    tensors += [(f"weights[{i}]", t) for i, pair in enumerate(weights) for t in pair]
    for name, t in tensors:
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    G = K // scales.shape[1] if bits == 4 else K
    if N % 8 or (G % 32 if bits == 4 else K % 64):
        raise NotImplementedError(
            f"the routed-expert kernels need N % 8 == 0 and, for int4, G % 32 == 0, for int8, "
            f"K % 64 == 0; got K={K}, N={N}, G={G}, bits={bits}")
    return R, K, N, E, G, bits


def grouped_quant_matmul_cuda(xs: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                              group_sizes: torch.Tensor, active: torch.Tensor,
                              starts: torch.Tensor) -> torch.Tensor:
    """Launch K7 on the current stream; returns f32 [R, N], 0 on rows
    outside every active expert's group. `grouped_quant_matmul_cuda.launches`
    counts the launches."""
    R, K, N, E, G, bits = _check_cuda_operands(xs, [(qweight, scales)], group_sizes, active, starts)
    out = torch.empty(R, N, dtype=torch.float32, device=xs.device)
    rc = _library().scalellm_moe_quant_decode(
        xs.data_ptr(), qweight.data_ptr(), scales.data_ptr(), active.data_ptr(), starts.data_ptr(),
        group_sizes.data_ptr(), out.data_ptr(), R, K, N, E, active.numel(), G, bits,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"routed quantized-expert kernel launch failed: CUDA error {rc}")
    grouped_quant_matmul_cuda.launches += 1
    return out


grouped_quant_matmul_cuda.launches = 0


def grouped_quant_matmul_pair_cuda(xs, qweight_gate, scales_gate, qweight_up, scales_up, group_sizes,
                                   active, starts) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K8 on the current stream; returns (gate, up), each f32 [R, N].
    `grouped_quant_matmul_pair_cuda.launches` counts the launches."""
    R, K, N, E, G, bits = _check_cuda_operands(
        xs, [(qweight_gate, scales_gate), (qweight_up, scales_up)], group_sizes, active, starts)
    out_gate = torch.empty(R, N, dtype=torch.float32, device=xs.device)
    out_up = torch.empty_like(out_gate)
    rc = _library().scalellm_moe_quant_decode_pair(
        xs.data_ptr(), qweight_gate.data_ptr(), scales_gate.data_ptr(), qweight_up.data_ptr(),
        scales_up.data_ptr(), active.data_ptr(), starts.data_ptr(), group_sizes.data_ptr(),
        out_gate.data_ptr(), out_up.data_ptr(), R, K, N, E, active.numel(), G, bits,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"routed quantized-expert pair kernel launch failed: CUDA error {rc}")
    grouped_quant_matmul_pair_cuda.launches += 1
    return out_gate, out_up


grouped_quant_matmul_pair_cuda.launches = 0


# Parameters of scalellm_expert_dequant_int4 in csrc/expert_dequant.cu, in
# order: qweight, scales, out; E, N, K, G; stream.
DEQUANT_ENTRY_POINTS = {"scalellm_expert_dequant_int4": [_P] * 3 + [_I] * 4 + [_P]}


def _dequant_library() -> ctypes.CDLL:
    lib = _build.load("expert_dequant")
    for name, argtypes in DEQUANT_ENTRY_POINTS.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def expert_dequant_cuda(qweight: torch.Tensor, scales: torch.Tensor, K: int) -> torch.Tensor:
    """Launch the INT4 expert dequantization on the current stream: packed
    int4 [E, N, K/2] and bf16 scales [E, K/G, N] -> bf16 [E, N, K], equal to
    plain_dequantize_experts_bf16 bit for bit. Takes every even K and every
    G that divides it; raises on anything else. `expert_dequant_cuda.launches`
    counts the launches."""
    if qweight.device.type != "cuda":
        raise ValueError(f"qweight must be a CUDA tensor, got {qweight.device}")
    if qweight.dtype not in (torch.int8, torch.uint8) or qweight.dim() != 3 or qweight.shape[2] * 2 != K:
        raise NotImplementedError(f"the expert dequantization takes packed int4 [E, N, K/2] at K={K}, got "
                                  f"{qweight.dtype} {tuple(qweight.shape)}")
    E, N, _ = qweight.shape
    n_groups = scales.shape[1] if scales.dim() == 3 else 0
    if (scales.dtype != torch.bfloat16 or scales.dim() != 3 or scales.shape[0] != E or scales.shape[2] != N
            or n_groups == 0 or K % n_groups):
        raise NotImplementedError(f"the expert dequantization takes bf16 scales [E, K/G, N] with G dividing "
                                  f"K={K}, got {scales.dtype} {tuple(scales.shape)}")
    if E > 65535 or N * K // 2 >= 2**31:
        raise NotImplementedError(f"the expert dequantization takes E <= 65535 and N K / 2 < 2^31, got E={E}, "
                                  f"N={N}, K={K}")
    for name, t in (("qweight", qweight), ("scales", scales)):
        if t.device != qweight.device:
            raise ValueError(f"{name} is on {t.device}, qweight on {qweight.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(E, N, K, dtype=torch.bfloat16, device=qweight.device)
    rc = _dequant_library().scalellm_expert_dequant_int4(
        qweight.data_ptr(), scales.data_ptr(), out.data_ptr(), E, N, K, K // n_groups,
        torch.cuda.current_stream(qweight.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"expert dequantization kernel launch failed: CUDA error {rc}")
    expert_dequant_cuda.launches += 1
    return out


expert_dequant_cuda.launches = 0
