"""What one 64-row step of K9/K10 costs on one card: the MLA kernels timed
with one block alone and with 132 at once (one an SM), over contexts of 64,
320 and 640 latent rows (1, 5 and 10 steps), for both kinds of blocks:

  - split: decodes of L rows through K9's entry point with one piece a
    slot (splits = 1), so each slot is one split block;
  - tile: sequences of 2 tokens at the tail of L rows through K10, one
    tile block each.

    python3 -m scalellm_tpu_torch.tools.mla_steps

(from the repository root). A step's cost is the slope between the
contexts; the time at 64 rows is a block's fixed cost (launch, metadata,
first copies, the merge). Times from chip_smoke.time_ms (L2 flushed before
each call), one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import torch

import chip_smoke as CS
from scalellm_tpu_torch.ops import mla_attention as M

H, DC, VD = 16, 576, 512


def main():
    if not torch.cuda.is_available():
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.mla_steps")
    card = CS.phase_device(torch)
    flush = torch.empty(CS.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(CS.SEED + 3)
    lib = M._library()
    us = {}
    for n in (1, 132):
        for L in (64, 320, 640):
            tiles = CS.latent_batch(torch, gen, q_lens=[M.TILE_TOKENS] * n, kv_lens=[L] * n, S=n,
                                    T=M.TILE_TOKENS * n, H=H, Dc=DC)
            us[f"tile/n{n}/L{L}"] = 1e3 * CS.time_ms(
                torch, lambda: M.mla_prefill_attention_cuda(**tiles, sm_scale=0.1, v_dim=VD), flush)
            dec = CS.latent_batch(torch, gen, q_lens=[1] * n, kv_lens=[L] * n, S=n, T=n, H=H, Dc=DC)
            maxp = dec["page_indices"].shape[1]
            page = dec["k_pages"].shape[1]
            split_len = -(-maxp * page // M.MLA_STEP) * M.MLA_STEP  # one piece a slot
            out = torch.empty(n, H, VD, dtype=torch.bfloat16, device="cuda")
            scratch = torch.empty(n * H * (VD + 2), dtype=torch.float32, device="cuda")

            def split_once():
                rc = lib.scalellm_mla_decode(
                    dec["q"].data_ptr(), dec["k_pages"].data_ptr(), dec["kv_lens"].data_ptr(),
                    dec["page_indices"].data_ptr(), out.data_ptr(), scratch.data_ptr(), n, n, maxp, page, H, DC,
                    VD, 1, split_len, 0.1, 0, 1.0, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    CS.fail(f"mla decode launch failed: CUDA error {rc}")

            split_once()
            torch.cuda.synchronize()
            want = M.plain_mla_decode(dec["q"], dec["k_pages"], dec["kv_lens"], dec["page_indices"], sm_scale=0.1,
                                      v_dim=VD)
            if not (out.float() - want.float()).abs().max().item() <= CS.KERNEL_TOL:
                CS.fail(f"split n={n} L={L}: differs from the plain version")
            us[f"split/n{n}/L{L}"] = 1e3 * CS.time_ms(torch, split_once, flush)
            del tiles, dec, out, scratch
    steps = {f"{kind}/n{n}": (us[f"{kind}/n{n}/L640"] - us[f"{kind}/n{n}/L64"]) / 9
             for kind in ("split", "tile") for n in (1, 132)}
    CS.emit(dict(phase="mla_steps", us=us, us_per_step=steps, card=card["nvidia_smi"]))


if __name__ == "__main__":
    main()
