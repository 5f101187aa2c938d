"""In-call A/B on one card: K12a gemv and K11 quant_mlp against the CUDA-core
kernels they replaced (the sources of commit 94e0989).

    mkdir -p build/small_m_base
    git archive 94e0989 scalellm_tpu_torch/csrc | tar -x -C build/small_m_base
    python3 -m scalellm_tpu_torch.tools.small_m_ab build/small_m_base/scalellm_tpu_torch/csrc

(from the repository root). The base sources are compiled with their own
headers into build/; their entry points take the scratch of the first
kernels (gemv: the inverse RMS and the split-K partials, split as the w4a8g
wrapper still splits; quant_mlp: the per-slice partials and a rows tile).
A base whose gemv entry point takes `k_slices` (commit 47fae36 on, e.g.
`git archive 0c56751` into build/small_m_parent) has the wrappers' own
interface: its libraries are then called through the wrappers themselves.

Cases: chip_smoke.py phase 3e's gemv shapes at M = 1, 16, 64 (the RMSNorm
prologue inside the call where plan() fuses it) and K11 at the 8B MLP at M
= 1, 8, 16, 32, 64, symmetric. Each kernel's output is held against its
plain version, then base and new are timed in turns (base, new, new, base)
with chip_smoke.time_ms. One JSON line per case, with the card's name and
power limit.
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
from scalellm_tpu_torch.ops import quant_mlp as QM

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The base entry points: gemv as in Q.GEMV_ENTRY_POINTS (inv_rms and part in
# place of xn and xsum, splits in place of k_slices); quant_mlp: x, gate_up
# (3), down (3), part, out; M, D, F, group_size, bits, scales_bf16, act,
# rows_tile; stream.
BASE_ARGTYPES = {
    "scalellm_quant_gemv": [_P] * 8 + [_I] * 8 + [_F, _P],
    "scalellm_quant_mlp": [_P] * 9 + [_I] * 8 + [_P],
}
BASE_SOURCES = {"quant_gemv": "scalellm_quant_gemv", "quant_mlp": "scalellm_quant_mlp"}


def build_base(csrc):
    """Start nvcc on each base source (with the base headers first on the
    include path); returns {name: (process, library)}."""
    out = _build.BUILD_DIR / "small_m_base"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in BASE_SOURCES:
        lib = out / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", str(lib), os.path.join(csrc, name + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return jobs


def bind_base(jobs, same_interface):
    """{name: entry point}, or with same_interface {name: library}."""
    fns = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            CS.fail(f"the base {name}.cu did not build:\n{log[-4000:]}")
        if same_interface:
            fns[name] = ctypes.CDLL(str(lib))
            continue
        entry = BASE_SOURCES[name]
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = BASE_ARGTYPES[entry], ctypes.c_int
        fns[name] = fn
    return fns


def through(libs, fn):
    """fn() with the port's wrappers loading the base libraries (a base with
    the wrappers' interface)."""
    real = _build.load
    _build.load = lambda name: libs[name]
    try:
        return fn()
    finally:
        _build.load = real


def base_splits(M, K, N, device):
    """The first gemv's split-K: 1 where its output tiles (1-16 rows x 32
    columns) give at least two blocks an SM, else enough whole 1024-K chunks
    per split to reach that."""
    rows = 1 if M <= 1 else 4 if M <= 4 else 8 if M <= 8 else 16
    blocks = -(-M // rows) * -(-N // 32)
    want = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    n_chunks = -(-K // 1024)
    if blocks >= want:
        return 1
    per = -(-n_chunks // min(n_chunks, -(-want // blocks)))
    return -(-n_chunks // per)


def base_gemv(fn, x, qweight, scales, zeros, bits, gamma, eps=1e-5):
    M, K = x.shape
    N = qweight.shape[0]
    splits = base_splits(M, K, N, x.device)
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    part = torch.empty(splits, M, N, dtype=torch.float32, device=x.device) if splits > 1 else None
    inv = torch.empty(M, dtype=torch.float32, device=x.device) if gamma is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), ptr(zeros), ptr(gamma), ptr(inv), ptr(part),
            out.data_ptr(), M, K, N, K // scales.shape[0], bits, int(scales.dtype == torch.bfloat16),
            int(gamma is not None and gamma.dtype == torch.bfloat16), splits, eps,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        CS.fail(f"base gemv launch failed: CUDA error {rc}")
    return out


def base_rows_tile(M, D, G, smem=232448):
    """The first K11's rows of x a block (1, 4, 8 or 16)."""
    bf = max(128, G)
    want = 1 if M <= 1 else 4 if M <= 4 else 8 if M <= 8 else 16
    for rows in (16, 8, 4, 1):
        if rows <= want and rows * (D * 2 + 3 * bf * 4 + (bf // G) * 4) <= smem:
            return rows
    CS.fail(f"the base quant_mlp cannot hold a row of x at D={D}")


def base_mlp(fn, x, gate_up, down, F, bits):
    (gq, gs, gz), (dq, ds, dz) = gate_up, down
    M, D = x.shape
    G = D // gs.shape[0]
    part = torch.empty(F // max(128, G), M, D, dtype=torch.float32, device=x.device)
    out = torch.empty(M, D, dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(x.data_ptr(), gq.data_ptr(), gs.data_ptr(), ptr(gz), dq.data_ptr(), ds.data_ptr(), ptr(dz),
            part.data_ptr(), out.data_ptr(), M, D, F, G, bits, int(gs.dtype == torch.bfloat16), 0,
            base_rows_tile(M, D, G), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        CS.fail(f"base quant_mlp launch failed: CUDA error {rc}")
    return out


def gemv_ab(card, fns, flush, same_interface):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 4)
    for shape, asym in CS.SMALL_M_SHAPES:
        K, N, bits, has_norm = CS.QUANT_SHAPES[shape]
        tile_n = Q.LM_HEAD_TILE_N if shape == "lm_head" else Q.DEFAULT_TILE_N
        qweight, scales, zeros = CS.quant_operands(torch, gen, K, N, bits, asym)
        w_bytes = sum(t.numel() * t.element_size() for t in (qweight, scales, zeros) if t is not None)
        for M in CS.SMALL_M_ROWS:
            x = (torch.randn(M, K, generator=gen, device="cuda") + 0.25).to(torch.bfloat16)
            gamma = None
            if has_norm:
                gamma = (torch.rand(K, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
                _, _, fuse = Q.plan(M, K, N, bits, CS.GROUP, scales.element_size(), True, variant="gemv",
                                    tile_n=tile_n)
                if not fuse:
                    x, gamma = Q.rms_prologue(x, gamma, 1e-5), None
            args = (x, qweight, scales, zeros, bits)
            new = lambda: Q.quant_gemv_cuda(*args, gamma, 1e-5)
            if same_interface:
                old = lambda: through(fns, new)
            else:
                old = lambda: base_gemv(fns["quant_gemv"], *args, gamma)
            want = Q.plain_gemv(*args, gamma, 1e-5).to(torch.bfloat16)
            errs = [CS.check_quant(torch, f"{tag} gemv {shape} M={M}", fn(), want)[0]
                    for tag, fn in (("base", old), ("new", new))]
            turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
            CS.emit(dict(phase="kernel_ab", kernel="quant_gemv", shape=shape + ("_asym" if asym else ""), M=M,
                         K=K, N=N, rms_prologue=gamma is not None, base_ms=[turns[0], turns[3]],
                         ms=[turns[1], turns[2]],
                         weight_gb_per_s=[w_bytes / (t * 1e-3) / 1e9 for t in turns],
                         max_abs_err_base_new=errs, card=card["nvidia_smi"]))
        del qweight, scales, zeros
        torch.cuda.empty_cache()


def mlp_ab(card, fns, flush, same_interface):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 5)
    D, F = CS.MLP_D, CS.MLP_F
    gq, gs, _ = CS.quant_operands(torch, gen, D, 2 * F, 4, False)
    dq, ds, _ = CS.quant_operands(torch, gen, F, D, 4, False)
    gate_up, down = (gq, gs.to(torch.bfloat16), None), (dq, ds.to(torch.bfloat16), None)
    w_bytes = sum(t.numel() * t.element_size() for t in gate_up + down if t is not None)
    for M in CS.MLP_ROWS:
        x = (torch.randn(M, D, generator=gen, device="cuda") + 0.25).to(torch.bfloat16)
        new = lambda: QM.quant_mlp_cuda(x, gate_up, down, F, 4, "silu")
        if same_interface:
            old = lambda: through(fns, new)
        else:
            old = lambda: base_mlp(fns["quant_mlp"], x, gate_up, down, F, 4)
        want = QM.plain_quant_mlp(x, gate_up, down, F, 4, "silu")
        top = want.abs().max().item()
        errs = []
        for tag, fn in (("base", old), ("new", new)):
            err = (fn() - want).abs().max().item()
            if not err <= CS.MLP_TOL_MAX * top:
                CS.fail(f"{tag} quant_mlp M={M}: differs from the plain version by {err} at magnitude {top}")
            errs.append(err)
        turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
        CS.emit(dict(phase="kernel_ab", kernel="quant_mlp", shape="llama8b_mlp", M=M, D=D, F=F,
                     base_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]],
                     weight_gb_per_s=[w_bytes / (t * 1e-3) / 1e9 for t in turns],
                     max_abs_err_base_new=errs, card=card["nvidia_smi"]))


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.small_m_ab BASE_CSRC_DIR")
    with open(os.path.join(sys.argv[1], "quant_gemv.cu")) as f:
        same_interface = "int k_slices" in f.read()
    card = CS.phase_device(torch)
    jobs = build_base(sys.argv[1])
    _build.build(["quant_gemv", "quant_mlp"])
    fns = bind_base(jobs, same_interface)
    flush = torch.empty(CS.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gemv_ab(card, fns, flush, same_interface)
    mlp_ab(card, fns, flush, same_interface)


if __name__ == "__main__":
    main()
