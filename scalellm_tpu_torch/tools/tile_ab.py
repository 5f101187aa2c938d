"""In-call A/B on one card: the K3/K4 tile kernel against the first one
(64 x 64 tiles, mma.sync), and the MoE combine against its index_add_ form.

    git show 9ba3630:scalellm_tpu_torch/csrc/quant_matmul.cu > build/base.cu
    python3 -m scalellm_tpu_torch.tools.tile_ab build/base.cu

(from the repository root; 9ba3630 is the last commit with the first tile
kernel, whose group/dequant entry points take no scratch and no tile).

Kernels: chip_smoke.py phase 3b's group and dequant cases on the same
inputs, each held against its plain version, then timed in turns (base,
new, new, base) with chip_smoke.time_ms. Combine, at DeepSeek-V2-Lite's
decode (T = 16) and prefill (T = 512) shapes (k = 6 of 64 experts, D =
2048): the index_add_ form, a stable sort of token_of (a form tried
before), and layers/moe.py:combine; per form its launches (torch.profiler),
its device time, its host time per call (100 calls, then one
synchronize) and whether 20 calls gave the same bits. One JSON line per
case, the card's name and power limit beside each.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time

import torch

import chip_smoke as CS
from scalellm_tpu_torch.layers import moe as TM
from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops import quant_matmul as Q

# The first tile kernel's group/dequant: x, qweight, scales, zeros,
# rms_gamma, out; M, K, N, group_size, bits, scales_bf16, gamma_bf16;
# rms_eps; stream.
BASE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def build_base(source):
    """Start nvcc on the base source (returns the process and its library)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "libquant_matmul_base.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
                             source], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def bind_base(proc, lib):
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        CS.fail(f"the base source did not build:\n{out[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    for name in ("group", "dequant"):
        fn = getattr(dll, "scalellm_quant_matmul_" + name)
        fn.argtypes, fn.restype = BASE_ARGTYPES, ctypes.c_int
    return dll


def base_call(dll, name, x, qweight, scales, zeros, bits, gamma, eps=1e-5):
    M, K = x.shape
    out = torch.empty(M, qweight.shape[0], dtype=torch.bfloat16, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = getattr(dll, "scalellm_quant_matmul_" + name)(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), ptr(zeros), ptr(gamma), out.data_ptr(),
        M, K, qweight.shape[0], K // scales.shape[0], bits, int(scales.dtype == torch.bfloat16),
        int(gamma is not None and gamma.dtype == torch.bfloat16), eps, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        CS.fail(f"base {name} launch failed: CUDA error {rc}")
    return out


def kernel_cases():
    """(shape, K, N, bits, G, bf16 scales, rms, kernel, M, asym): phase 3b's
    group and dequant cases."""
    ds_K, ds_N, ds_G = CS.deepseek_shared_down()
    cases = []
    for shape, (K, N, bits, rms) in CS.QUANT_SHAPES.items():
        if shape == "qkv_proj_k2048":
            runs = [("dequant", 128, False), ("group", 128, False)]
        else:
            runs = [("dequant", 512, False), ("group", 512, False)]
            runs += {"o_proj": [("dequant", 512, True), ("group", 512, True)],
                     "gate_up_proj": [("dequant", 128, False), ("dequant", 256, False)]}.get(shape, [])
        cases += [(shape, K, N, bits, CS.GROUP, False, rms) + r for r in runs]
    return cases + [("deepseek_shared_down", ds_K, ds_N, 4, ds_G, True, False, "dequant", 16, False)]


def kernel_ab(card, dll, flush):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 1)
    for shape, K, N, bits, G, bf16_scales, rms, name, M, asym in kernel_cases():
        qweight, scales, zeros = CS.quant_operands(torch, gen, K, N, bits, asym, group=G, bf16_scales=bf16_scales)
        x = (torch.randn(M, K, generator=gen, device="cuda") + 0.25).to(torch.bfloat16)
        gamma = None
        if rms:
            gamma = (torch.rand(K, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
            _, _, fuse = Q.plan(M, K, N, bits, G, scales.dtype.itemsize, True, variant=name)
            if not fuse:
                x, gamma = Q.rms_prologue(x, gamma, 1e-5), None
        args = (x, qweight, scales, zeros, bits)
        new = lambda: getattr(Q, f"quant_matmul_{name}_cuda")(*args, gamma, 1e-5)
        old = lambda: base_call(dll, name, *args, gamma)
        want = getattr(Q, f"plain_{name}")(*args, gamma, 1e-5).to(torch.bfloat16)
        errs = [CS.check_quant(torch, f"{tag} {name} {shape} M={M}", fn(), want)[0]
                for tag, fn in (("base", old), ("new", new))]
        turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
        CS.emit(dict(phase="kernel_ab", kernel="quant_matmul_" + name, shape=shape, M=M, K=K, N=N, G=G,
                     asymmetric=asym, rms_prologue=gamma is not None, base_ms=[turns[0], turns[3]],
                     ms=[turns[1], turns[2]], max_abs_err_base_new=errs, card=card["nvidia_smi"]))
        del qweight, scales, zeros, x, want


def combine_index_add(y, topk_w, order, token_of, n_tokens):
    """The combine of the first DeepSeek slice: f32 atomics on the card."""
    y = y * topk_w.reshape(-1)[order].float()[:, None]
    out = torch.zeros(n_tokens, y.shape[-1], dtype=torch.float32, device=y.device)
    return out.index_add_(0, token_of, y)


def combine_sorted(y, topk_w, order, token_of, n_tokens):
    """A stable sort of token_of lists each token's rows in sorted-row order."""
    y = y * topk_w.reshape(-1)[order].float()[:, None]
    rows = torch.sort(token_of, stable=True).indices.view(n_tokens, -1)
    return y[rows].sum(dim=1)


def combine_ab(card, flush):
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 2)
    E, k, D = 64, 6, 2048
    forms = dict(index_add=combine_index_add, sorted=combine_sorted, inverse=TM.combine)
    for T in (16, 512):
        probs = torch.softmax(torch.randn(T, E, generator=gen, device="cuda"), -1)
        topk_w, topk_e = torch.topk(probs, k)
        order, token_of, _ = TM.dispatch(topk_e, E)
        y = torch.randn(T * k, D, generator=gen, device="cuda")
        args = (y, topk_w, order, token_of, T)
        want = combine_index_add(*args).double()
        for name, fn in forms.items():
            err = (fn(*args).double() - want).abs().max().item()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(*args)
                torch.cuda.synchronize()
            launches = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
            ms = CS.time_ms(torch, lambda: fn(*args), flush)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn(*args)
            torch.cuda.synchronize()
            host_us = (time.perf_counter() - t0) * 1e4
            outs = [fn(*args) for _ in range(20)]
            same = all(torch.equal(outs[0], o) for o in outs[1:])
            CS.emit(dict(phase="combine_ab", form=name, T=T, k=k, D=D, launches=launches, ms=ms,
                         host_us_per_call=host_us, bit_identical_over_20=same, max_abs_err_vs_index_add=err,
                         card=card["nvidia_smi"]))


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.tile_ab BASE_QUANT_MATMUL_CU")
    card = CS.phase_device(torch)
    proc, lib = build_base(sys.argv[1])
    _build.build(["quant_matmul"])
    dll = bind_base(proc, lib)
    flush = torch.empty(CS.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kernel_ab(card, dll, flush)
    combine_ab(card, flush)


if __name__ == "__main__":
    main()
