"""In-call A/B on one card: K7 and K8, the routed quantized-expert kernels,
against the kernels they replaced (the moe_quant.cu of commit 0c56751: a
block per (active slot, 128 columns), 16-byte loads straight from global
memory, no ring).

    mkdir -p build/moe_quant_base
    git archive 0c56751 scalellm_tpu_torch/csrc | tar -x -C build/moe_quant_base
    python3 -m scalellm_tpu_torch.tools.moe_quant_ab build/moe_quant_base/scalellm_tpu_torch/csrc

(from the repository root). The base source is compiled with its own
headers into build/; its entry points take the same arguments as the new
ones (ops/moe_quant.py's ENTRY_POINTS). Cases: every chip_smoke.py phase-3d
case (chip_smoke.moe_quant_cases). Each kernel's output is held against
the plain version (chip_smoke.check_moe_quant), then base and new are timed
in turns (base, new, new, base) with chip_smoke.time_ms, beside the two
output memsets the base kernel runs (timed alone: what folding the zeroing
into the new kernel saves). One JSON line per case, with the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as CS
from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops import moe_quant as MQ


def build_base(csrc):
    """Compile the base source into build/; returns its library, entry points
    bound as ops/moe_quant.py binds the new ones."""
    out = _build.BUILD_DIR / "moe_quant_base"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libmoe_quant.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", str(lib_path), os.path.join(csrc, "moe_quant.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900)
    if proc.returncode != 0:
        CS.fail(f"the base moe_quant.cu did not build:\n{proc.stdout[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in MQ.ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def base_call(lib, xs, *rest):
    """The base kernel on a wrapper's arguments (xs, qweight, scales[,
    qweight, scales], sizes, active, starts): a tuple of f32 outputs."""
    weights, (sizes, active, starts) = rest[:-3], rest[-3:]
    pairs = [tuple(weights[i:i + 2]) for i in range(0, len(weights), 2)]
    R, K, N, E, G, bits = MQ._check_cuda_operands(xs, pairs, sizes, active, starts)
    outs = [torch.empty(R, N, dtype=torch.float32, device=xs.device) for _ in pairs]
    ints = (R, K, N, E, active.numel(), G, bits, torch.cuda.current_stream().cuda_stream)
    ptrs = [xs.data_ptr(), *[t.data_ptr() for t in weights], active.data_ptr(), starts.data_ptr(), sizes.data_ptr()]
    fn = lib.scalellm_moe_quant_decode_pair if len(pairs) == 2 else lib.scalellm_moe_quant_decode
    rc = fn(*ptrs, *[o.data_ptr() for o in outs], *ints)
    if rc != 0:
        CS.fail(f"base moe_quant launch failed: CUDA error {rc}")
    return tuple(outs)


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.moe_quant_ab BASE_CSRC_DIR")
    card = CS.phase_device(torch)
    lib = build_base(sys.argv[1])
    _build.build(["moe_quant"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 3)
    flush = torch.empty(CS.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for c in CS.moe_quant_cases(torch, gen):
        args = c["args"]
        if c["proj"] == "gate_up":
            new = lambda: MQ.grouped_quant_matmul_pair_cuda(*args)
            want = MQ.plain_grouped_quant_matmul_pair(*args)
        else:
            new = lambda: (MQ.grouped_quant_matmul_cuda(*args),)
            want = (MQ.plain_grouped_quant_matmul(*args),)
        old = lambda: base_call(lib, *args)
        errs = [CS.check_moe_quant(torch, f"{tag} {c['name']}", fn(), want, c["covered"])[0]
                for tag, fn in (("base", old), ("new", new))]
        turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
        outs = old()
        memset_ms = CS.time_ms(torch, lambda: [o.zero_() for o in outs], flush)
        w_bytes = c["n_active"] * sum(q[0].numel() * q.element_size() + sc[0].numel() * sc.element_size()
                                      for q, sc in c["weights"])
        CS.emit(dict(phase="kernel_ab", kernel="moe_quant_decode_pair" if c["proj"] == "gate_up" else "moe_quant_decode",
                     shape=c["name"], R=c["x"].shape[0], K=c["K"], N=c["N"], active_experts=c["n_active"],
                     base_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]], memset_ms=memset_ms,
                     weight_gb_per_s=[w_bytes / (t * 1e-3) / 1e9 for t in turns],
                     max_abs_err_base_new=errs, card=card["nvidia_smi"]))


if __name__ == "__main__":
    main()
