"""In-call A/B on one card: K9 and K10, the MLA attention kernels, against
the kernels they replaced (the mla_attention.cu of commit a8887cd: one block
per query token and head group walking the whole context).

    mkdir -p build/mla_base
    git archive a8887cd scalellm_tpu_torch/csrc | tar -x -C build/mla_base
    python3 -m scalellm_tpu_torch.tools.mla_ab build/mla_base/scalellm_tpu_torch/csrc

(from the repository root). Cases: every chip_smoke.py phase-3c MLA shape
(chip_smoke.MLA_SHAPES), at DeepSeek-V2-Lite's 16 heads and softmax scale.
Each kernel's output is held against the plain version (within
chip_smoke.KERNEL_TOL, and row by row within chip_smoke.ATTENTION_REL_TOL of
the row's size), then base and new are timed in turns (base, new, new,
base) with chip_smoke.time_ms. One JSON line per case, with the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as CS
from scalellm_tpu_torch.models.deepseek import yarn_get_mscale
from scalellm_tpu_torch.ops import _build
from scalellm_tpu_torch.ops import mla_attention as M

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The base entry points: decode 5 pointers (q .. out), 7 ints (num_rows ..
# v_dim), sm_scale, stream; prefill 7 pointers (q .. out), 7 ints
# (num_tokens .. v_dim), sm_scale, stream.
BASE_ARGTYPES = {
    "scalellm_mla_decode": [_P] * 5 + [_I] * 7 + [_F, _P],
    "scalellm_mla_prefill": [_P] * 7 + [_I] * 7 + [_F, _P],
}


def build_base(csrc):
    """Compile the base source into build/; returns its library with bound
    entry points."""
    out = _build.BUILD_DIR / "mla_base"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libmla_attention.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", str(lib), os.path.join(csrc, "mla_attention.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900)
    if proc.returncode != 0:
        CS.fail(f"the base mla_attention.cu did not build:\n{proc.stdout[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in BASE_ARGTYPES.items():
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return dll


def base_mla(lib, inputs, decode_only, sm_scale, v_dim):
    q, k = inputs["q"], inputs["k_pages"]
    T, H, Dc = q.shape
    S, maxp = inputs["page_indices"].shape
    out = torch.empty(T, H, v_dim, dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    if decode_only:
        rc = lib.scalellm_mla_decode(q.data_ptr(), k.data_ptr(), inputs["kv_lens"].data_ptr(),
                                     inputs["page_indices"].data_ptr(), out.data_ptr(), T, S, maxp, k.shape[1],
                                     H, Dc, v_dim, sm_scale, stream)
    else:
        rc = lib.scalellm_mla_prefill(q.data_ptr(), k.data_ptr(), inputs["kv_lens"].data_ptr(),
                                      inputs["page_indices"].data_ptr(), inputs["cu_q_lens"].data_ptr(),
                                      inputs["num_seqs"].data_ptr(), out.data_ptr(), T, S, maxp, k.shape[1], H,
                                      Dc, v_dim, sm_scale, stream)
    if rc != 0:
        CS.fail(f"base mla launch failed: CUDA error {rc}")
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
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.mla_ab BASE_CSRC_DIR")
    card = CS.phase_device(torch)
    base = build_base(sys.argv[1])
    _build.build(["mla_attention"])
    cfg = CS.DEEPSEEK_V2_LITE
    H, vd = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    Dc = vd + cfg["qk_rope_head_dim"]
    yarn = cfg["rope_scaling"]
    sm_scale = ((cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
                * yarn_get_mscale(yarn["factor"], yarn["mscale_all_dim"]) ** 2)
    flush = torch.empty(CS.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 2)
    for name, spec in CS.MLA_SHAPES.items():
        inputs = CS.latent_batch(torch, gen, q_lens=spec["q_lens"], kv_lens=spec["kv_lens"], S=spec["S"],
                                 T=spec["T"], H=H, Dc=Dc)
        decode_only = all(n == 1 for n in spec["q_lens"])
        n_real = sum(spec["q_lens"])
        want = M.plain_mla_paged_attention(**inputs, sm_scale=sm_scale, v_dim=vd, decode_only=decode_only)
        old = lambda: base_mla(base, inputs, decode_only, sm_scale, vd)
        if decode_only:
            args = (inputs["q"], inputs["k_pages"], inputs["kv_lens"], inputs["page_indices"])
            new = lambda: M.mla_decode_attention_cuda(*args, sm_scale=sm_scale, v_dim=vd)
        else:
            new = lambda: M.mla_prefill_attention_cuda(**inputs, sm_scale=sm_scale, v_dim=vd)
        base_err = check(f"base {name}", old(), want, n_real)
        err = check(f"new {name}", new(), want, n_real)
        turns = [CS.time_ms(torch, fn, flush) for fn in (old, new, new, old)]
        line = dict(phase="kernel_ab", kernel="mla_decode" if decode_only else "mla_prefill", shape=name,
                    base_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]],
                    speedup=(turns[0] + turns[3]) / (turns[1] + turns[2]),
                    max_abs_err_base_new=[base_err, err])
        CS.emit(dict(line, card=card["nvidia_smi"]))
        del inputs, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
