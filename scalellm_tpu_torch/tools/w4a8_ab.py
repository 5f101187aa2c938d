"""In-call A/B on one card: the W4A8 kernels K2 (w4a8) and K12b (w4a8g) on
the integer small-M mainloop against the kernels they replaced (the sources
of commit c5ed9ef: K2 a block of 8 columns whose 4 warps walk K with
mma.sync, x the A operand; K12b a CUDA-core dp4a GEMV with split-K
partials).

    mkdir -p build/w4a8_base
    git archive c5ed9ef scalellm_tpu_torch/csrc | tar -x -C build/w4a8_base
    python3 -m scalellm_tpu_torch.tools.w4a8_ab build/w4a8_base/scalellm_tpu_torch/csrc

(from the repository root). The base sources are compiled with their own
headers into build/; their entry points take the first kernels' scratch
(K2: xq, sx per k-block, xsum per group; K12b: the same per 128-K span, and
the split-K partials, split as the first wrapper split them).

Cases: chip_smoke.py phase 3e's shapes (the five Llama-3.1-8B projections,
o also with zero points) at M = 1, 16, 64, block_k and the RMSNorm prologue
as plan() picks them for each variant; then K2 at the DeepSeek-V2-Lite
projections a phase-7 decode step runs (M = 16, int4 at G = 128 with bf16
scales, as quantize="int4" stores them). Each kernel's output is held
against its plain version (chip_smoke.check_quant), then base and new are
timed in turns (base, new, new, base) with chip_smoke.time_ms, beside one
bf16 matmul on weights dequantized ahead of time (x normed ahead). One JSON
line per case, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as CS
from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops import quant_matmul as Q
from scalellm_tpu_torch.tools.small_m_ab import base_splits

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The base entry points. K2: x, qweight, scales, zeros, rms_gamma, xq, sx,
# xsum, out; M, K, N, group_size, bits, scales_bf16, gamma_bf16, block_k;
# rms_eps; stream. K12b: the same with part after xsum and splits after
# block_k.
BASE = {
    "quant_matmul": ("scalellm_quant_matmul_w4a8", [_P] * 9 + [_I] * 8 + [_F, _P]),
    "quant_gemv": ("scalellm_quant_w4a8_gemv", [_P] * 10 + [_I] * 9 + [_F, _P]),
}
VARIANTS = {"w4a8": (Q.quant_matmul_w4a8_cuda, Q.plain_w4a8, "quant_matmul"),
            "w4a8g": (Q.quant_w4a8_gemv_cuda, Q.plain_w4a8g, "quant_gemv")}


def build_base(csrc):
    """Compile the base sources (with the base headers first on the include
    path) into build/; returns {source name: bound entry point}."""
    out = _build.BUILD_DIR / "w4a8_base"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in BASE:
        lib = out / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", str(lib), os.path.join(csrc, name + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            CS.fail(f"the base {name}.cu did not build:\n{log[-4000:]}")
        entry, argtypes = BASE[name]
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def base_call(fn, variant, x, qweight, scales, zeros, bits, block_k, gamma, eps=1e-5):
    """The base kernel on a wrapper's arguments: bf16 [M, N]."""
    M, K = x.shape
    N = qweight.shape[0]
    G = K // scales.shape[0]
    dev = x.device
    span = G if variant == "w4a8" else 128
    out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    xq = torch.empty(M, K, dtype=torch.int8, device=dev)
    sx = torch.empty(M, K // block_k, dtype=torch.float32, device=dev)
    xsum = None if zeros is None else torch.empty(M, K // span, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    head = [x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), ptr(zeros), ptr(gamma), xq.data_ptr(),
            sx.data_ptr(), ptr(xsum)]
    ints = [M, K, N, G, bits, int(scales.dtype == torch.bfloat16),
            int(gamma is not None and gamma.dtype == torch.bfloat16), block_k]
    stream = torch.cuda.current_stream().cuda_stream
    if variant == "w4a8":
        rc = fn(*head, out.data_ptr(), *ints, eps, stream)
    else:
        splits = base_splits(M, K, N, dev)
        part = torch.empty(splits, M, N, dtype=torch.float32, device=dev) if splits > 1 else None
        rc = fn(*head, ptr(part), out.data_ptr(), *ints, splits, eps, stream)
    if rc != 0:
        CS.fail(f"base {variant} launch failed: CUDA error {rc}")
    return out


def deepseek_shapes():
    """(name, K, N) of the DeepSeek-V2-Lite projections that K2 runs on a
    phase-7 decode step: q, o, the shared experts' gate_up and the lm_head."""
    c = CS.DEEPSEEK_V2_LITE
    D, H = c["hidden_size"], c["num_attention_heads"]
    return (("ds_q_proj", D, H * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"])),
            ("ds_o_proj", H * c["v_head_dim"], D),
            ("ds_shared_gate_up", D, 2 * c["moe_intermediate_size"] * c["n_shared_experts"]),
            ("ds_lm_head", D, c["vocab_size"]))


def ab_case(card, fns, flush, name, variants, x, gamma, qweight, scales, zeros, bits, tile_n, library_ms, w_bytes):
    """Each variant at one shape: held against its plain version, then base
    and new in turns; one JSON line each."""
    M, K = x.shape
    N = qweight.shape[0]
    xn = x if gamma is None else Q.rms_prologue(x, gamma, 1e-5)
    for variant in variants:
        wrapper, plain_fn, source = VARIANTS[variant]
        _, block_k, fuse = Q.plan(M, K, N, bits, K // scales.shape[0], scales.element_size(), gamma is not None,
                                  variant=variant, tile_n=tile_n)
        xv, g = (x, gamma) if fuse else (xn, None)
        args = (xv, qweight, scales, zeros, bits, block_k)
        new = lambda: wrapper(*args, g, 1e-5)
        old = lambda: base_call(fns[source], variant, *args, g)
        want = plain_fn(*args, g, 1e-5).to(torch.bfloat16)
        errs = [CS.check_quant(torch, f"{tag} {variant} {name} M={M}", fn(), want)[0]
                for tag, fn in (("base", old), ("new", new))]
        turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
        CS.emit(dict(phase="kernel_ab", kernel="quant_" + variant, shape=name, M=M, K=K, N=N, bits=bits,
                     block_k=block_k, rms_prologue=g is not None, base_ms=[turns[0], turns[3]],
                     ms=[turns[1], turns[2]], library_ms=library_ms,
                     weight_gb_per_s=[w_bytes / (t * 1e-3) / 1e9 for t in turns],
                     max_abs_err_base_new=errs, card=card["nvidia_smi"]))


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.w4a8_ab BASE_CSRC_DIR")
    card = CS.phase_device(torch)
    fns = build_base(sys.argv[1])
    _build.build(["quant_matmul", "quant_gemv"])
    flush = torch.empty(CS.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 6)
    cases = [(shape + ("_asym" if asym else ""), *CS.QUANT_SHAPES[shape], asym, CS.SMALL_M_ROWS, tuple(VARIANTS),
              False, Q.LM_HEAD_TILE_N if shape == "lm_head" else Q.DEFAULT_TILE_N)
             for shape, asym in CS.SMALL_M_SHAPES]
    cases += [(name, K, N, 4, False, False, (16,), ("w4a8",), True,
               Q.LM_HEAD_TILE_N if name == "ds_lm_head" else Q.DEFAULT_TILE_N) for name, K, N in deepseek_shapes()]
    for name, K, N, bits, has_norm, asym, rows, variants, bf16_scales, tile_n in cases:
        qweight, scales, zeros = CS.quant_operands(torch, gen, K, N, bits, asym, bf16_scales=bf16_scales)
        wd = CS.dequantized(torch, qweight, scales, zeros, bits)
        w_bytes = sum(t.numel() * t.element_size() for t in (qweight, scales, zeros) if t is not None)
        for M in rows:
            x = (torch.randn(M, K, generator=gen, device="cuda") + 0.25).to(torch.bfloat16)
            gamma = (torch.rand(K, generator=gen, device="cuda") + 0.5).to(torch.bfloat16) if has_norm else None
            xn = x if gamma is None else Q.rms_prologue(x, gamma, 1e-5)
            library_ms = CS.time_ms(torch, lambda: torch.matmul(xn, wd.T), flush)
            ab_case(card, fns, flush, name, variants, x, gamma, qweight, scales, zeros, bits, tile_n, library_ms,
                    w_bytes)
            del x, xn
        del qweight, scales, zeros, wd
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
