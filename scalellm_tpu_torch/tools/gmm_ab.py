"""In-call A/B on one card: K6, the grouped GEMM, against the kernel it
replaced (the grouped_matmul.cu of commit 2d6a02b: mma.sync fragments
loaded straight from global memory, no shared memory), and the INT4 expert
dequantization against the PyTorch form it replaced.

    mkdir -p build/gmm_base
    git archive 2d6a02b scalellm_tpu_torch/csrc | tar -x -C build/gmm_base
    python3 -m scalellm_tpu_torch.tools.gmm_ab build/gmm_base/scalellm_tpu_torch/csrc

(from the repository root). The base source is compiled with its own
headers into build/; its entry point takes the same arguments as the new
one, its last int being the row tile (1 or 4 m16 tiles a block, chosen as
its wrapper chose it: 4 from 32 rows per expert on average). Cases: every
chip_smoke.py phase-3c shape at DeepSeek-V2-Lite's widths
(chip_smoke.gmm_cases). Each kernel's output is
held against the plain version within chip_smoke.GMM_TOL of its magnitude,
then base and new are timed in turns (base, new, new, base) with
chip_smoke.time_ms. Then, at DeepSeek-V2-Lite's gate/up and down (64
experts, int4, group 128), the PyTorch dequantization the port ran before
(chip_smoke.pytorch_expert_dequant) and the new kernel, in turns on the same
inputs. One JSON line per case, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as CS
from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops import grouped_matmul as G
from scalellm_tpu_torch.ops import moe_quant as MQ


def build_base(csrc):
    """Compile the base source into build/; returns its library, the entry
    point bound as ops/grouped_matmul.py binds the new one."""
    out = _build.BUILD_DIR / "gmm_base"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libgrouped_matmul.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", str(lib_path),
           os.path.join(csrc, "grouped_matmul.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900)
    if proc.returncode != 0:
        CS.fail(f"the base grouped_matmul.cu did not build:\n{proc.stdout[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in G.ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def base_call(lib, xs, w, sizes):
    """The base kernel: f32 [R, N], uncovered rows unwritten."""
    R, K = xs.shape
    E, N, _ = w.shape
    out = torch.empty(R, N, dtype=torch.float32, device=xs.device)
    m_tiles = 4 if R >= 32 * E else 1
    rc = lib.scalellm_grouped_matmul(xs.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(), R, K, N, E,
                                     m_tiles, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        CS.fail(f"base grouped_matmul launch failed: CUDA error {rc}")
    return out


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.gmm_ab BASE_CSRC_DIR")
    card = CS.phase_device(torch)
    lib = build_base(sys.argv[1])
    _build.build(["grouped_matmul", "expert_dequant"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 2)
    flush = torch.empty(CS.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for model, step, proj, xs, w, sizes in CS.gmm_cases(torch, gen):
        if model != "v2_lite":  # the shapes the base kernel was timed at
            continue
        want = G.plain_grouped_matmul(xs, w, sizes)
        top = want.abs().max().item()
        old = lambda: base_call(lib, xs, w, sizes)
        new = lambda: G.grouped_matmul_cuda(xs, w, sizes)
        errs = []
        for tag, fn in (("base", old), ("new", new)):
            got = fn()
            torch.cuda.synchronize()
            errs.append((got - want).abs().max().item())
            if not errs[-1] <= CS.GMM_TOL * top:
                CS.fail(f"gmm_ab {tag} {step}_{proj}: differs from the plain version by {errs[-1]} at {top}")
        turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
        CS.emit(dict(phase="kernel_ab", kernel="grouped_matmul", shape=f"{step}_{proj}", R=xs.shape[0],
                     K=w.shape[2], N=w.shape[1], active_experts=int((sizes > 0).sum()),
                     new_tile=list(G.TILES[G.tile_for(xs.shape[0], w.shape[0])]),
                     base_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]],
                     speedup=(turns[0] + turns[3]) / (turns[1] + turns[2]), max_abs_err_base_new=errs,
                     tol=CS.GMM_TOL * top, card=card["nvidia_smi"]))
        del xs, w, want
    cfg = CS.DEEPSEEK_V2_LITE
    D, Fm, E = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    for proj, K, N in (("gate_up", D, Fm), ("down", Fm, D)):
        qweight = torch.randint(-128, 128, (E, N, K // 2), generator=gen, device="cuda", dtype=torch.int8)
        scales = ((torch.rand(E, K // CS.GROUP, N, generator=gen, device="cuda") + 0.5) * 0.01).to(torch.bfloat16)
        old = lambda: CS.pytorch_expert_dequant(torch, qweight, scales, K)
        new = lambda: MQ.expert_dequant_cuda(qweight, scales, K)
        got = new()
        same = torch.equal(old(), torch.cat([got[..., 0::2], got[..., 1::2]], dim=-1))
        if not same:
            CS.fail(f"gmm_ab expert_dequant {proj}: the kernel and the PyTorch form give other values")
        turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
        nbytes = qweight.numel() + scales.numel() * 2 + got.numel() * 2
        CS.emit(dict(phase="kernel_ab", kernel="expert_dequant", shape=proj, E=E, K=K, N=N, G=CS.GROUP,
                     pytorch_form_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]],
                     speedup=(turns[0] + turns[3]) / (turns[1] + turns[2]),
                     bound_ms=1e3 * nbytes / CS.HBM_BYTES_PER_S, same_values=same, card=card["nvidia_smi"]))
        del qweight, scales, got


if __name__ == "__main__":
    main()
