"""In-call A/B on one card: K1, ragged paged attention, against the kernel
it replaced (the ragged_paged_attention.cu of commit 47fae36: one block per
query token and KV head, CUDA-core dots from shared memory).

    mkdir -p build/attention_base
    git archive 47fae36 scalellm_tpu_torch/csrc | tar -x -C build/attention_base
    python3 -m scalellm_tpu_torch.tools.attention_ab build/attention_base/scalellm_tpu_torch/csrc

(from the repository root). Cases: every chip_smoke.py phase-3a shape
(chip_smoke.ATTENTION_SHAPES) that the base kernel takes (bf16, head dims
64 and 128, no ALiBi). Each kernel's output is held against the
plain version (within chip_smoke.KERNEL_TOL, and row by row within
chip_smoke.ATTENTION_REL_TOL of the row's size), then base and new are
timed in turns (base, new, new, base) with chip_smoke.time_ms. One JSON
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
from scalellm_tpu_torch.ops import attention as A
from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The base entry point: 7 pointers (q .. out), 7 ints (num_tokens ..
# head_dim), sm_scale, window, soft_cap, stream.
BASE_ARGTYPES = [_P] * 7 + [_I] * 7 + [_F, _I, _F, _P]


def build_base(csrc):
    """Compile the base source into build/; returns its bound entry point."""
    out = _build.BUILD_DIR / "attention_base"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libragged_paged_attention.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", str(lib),
           os.path.join(csrc, "ragged_paged_attention.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900)
    if proc.returncode != 0:
        CS.fail(f"the base ragged_paged_attention.cu did not build:\n{proc.stdout[-4000:]}")
    fn = ctypes.CDLL(str(lib)).scalellm_ragged_paged_attention
    fn.argtypes, fn.restype = BASE_ARGTYPES, ctypes.c_int
    return fn


def base_attention(fn, inputs, sm_scale, window, cap):
    q, kv = inputs["q"], inputs["kv_pages"]
    T, H, D = q.shape
    S, maxp = inputs["page_indices"].shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kv.data_ptr(), inputs["kv_lens"].data_ptr(), inputs["page_indices"].data_ptr(),
            inputs["cu_q_lens"].data_ptr(), inputs["num_seqs"].data_ptr(), out.data_ptr(), T, S, maxp,
            kv.shape[1], H, kv.shape[2] // 2, D, sm_scale, window or 0, cap or 0.0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        CS.fail(f"base attention launch failed: CUDA error {rc}")
    return out


def check(tag, got, want, n_real):
    err = (got.float() - want.float()).abs().max().item()
    rel_err = CS.attention_row_rel_err(torch, got, want)
    if not (torch.isfinite(got).all() and torch.all(got[n_real:] == 0) and err <= CS.KERNEL_TOL
            and rel_err <= CS.ATTENTION_REL_TOL):
        CS.fail(f"{tag}: differs from the plain version by {err}, {rel_err} of a row "
                "(or non-finite or padding not zero)")
    return err


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.attention_ab BASE_CSRC_DIR")
    card = CS.phase_device(torch)
    base = build_base(sys.argv[1])
    _build.build(["ragged_paged_attention"])
    flush = torch.empty(CS.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED)
    for name, spec in CS.ATTENTION_SHAPES.items():
        if spec.get("alibi") or spec.get("dtype") or spec["D"] not in (64, 128):
            continue
        inputs = CS.make_batch(torch, gen, q_lens=spec["q_lens"], kv_lens=spec["kv_lens"], S=spec["S"],
                               T=spec["T"], H=spec["H"], Hkv=spec["Hkv"], D=spec["D"])
        kw = dict(sm_scale=spec["D"] ** -0.5, sliding_window=spec["window"], logit_soft_cap=spec["cap"])
        n_real = sum(spec["q_lens"])
        want = ref_ragged_paged_attention(**inputs, **kw)
        old = lambda: base_attention(base, inputs, kw["sm_scale"], spec["window"], spec["cap"])
        new = lambda: A.ragged_paged_attention_cuda(**inputs, **kw)
        base_err = check(f"base {name}", old(), want, n_real)
        err = check(f"new {name}", new(), want, n_real)
        turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
        CS.emit(dict(phase="kernel_ab", kernel="ragged_paged_attention", shape=name,
                     base_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]],
                     max_abs_err_base_new=[base_err, err], card=card["nvidia_smi"]))
        del inputs, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
