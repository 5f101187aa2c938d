"""How far rounding alone moves the logits of chip_smoke.py's phases 10 and
11 between two implementations, on one card: Gemma-2-9B and Qwen3-8B
checkpoints written with phases 4-9's random weights (every weight
N(0, 0.02), chip_smoke.flat_init), served by LLM(path) and LLM(path,
quantize="int4"), and phases 10 and 11's logits check (one prefill and one
decode batch, chip_smoke's) run with the kernels against the plain
versions, and with one kernel family swapped alone:

  - all: K1 and the quantized matmuls against all plain;
  - attention: K1 alone (the quantized matmuls plain on both sides);
  - quant: the quantized matmuls alone (plain attention on both sides);
  - all_dequant (INT4): all, with every projection forced to dequant.

Qwen3 also at 18 and 24 layers. Max and mean absolute logits differences,
one JSON line a model and mode, with the card's name and power limit:

    python3 -m scalellm_tpu_torch.tools.logits_drift

(from the repository root; about 3 minutes).
"""

from __future__ import annotations

import functools
import shutil

import torch

import chip_smoke as CS
from scalellm_tpu_torch.ops import attention
from scalellm_tpu_torch.ops import quant_matmul as Q

CASES = (("gemma2", CS.GEMMA2_9B, CS.gemma2_checkpoint_tensors, 42),
         ("qwen3", CS.QWEN3_8B, CS.qwen3_checkpoint_tensors, 36),
         ("qwen3", CS.QWEN3_8B, CS.qwen3_checkpoint_tensors, 24),
         ("qwen3", CS.QWEN3_8B, CS.qwen3_checkpoint_tensors, 18))


def logits(model, prefill, decode, n_tok, n_seq, n_pages, attn_kernel, quant_kernel, variant=""):
    """Prefill then decode logits through `model`, the kernels or the plain
    versions as asked."""
    model.attn_impl = attention.ragged_paged_attention if attn_kernel else attention.plain_ragged_paged_attention
    quant = Q.quant_matmul if quant_kernel else Q.plain_quant_matmul
    model.quant_impl = functools.partial(quant, variant=variant) if variant else quant
    kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=CS.DEVICE)
    a = model.logits(model(kv, prefill.to(CS.DEVICE), all_hidden=True)[:n_tok])
    b = model.logits(model(kv, decode.to(CS.DEVICE), decode_only=True)[:n_seq])
    return a, b


def main():
    if not torch.cuda.is_available():
        CS.fail("usage on a CUDA card: python3 -m scalellm_tpu_torch.tools.logits_drift")
    card = CS.phase_device(torch)
    for name, base, tensors_of, layers in CASES:
        cfg = dict(base, num_hidden_layers=layers)
        path, _, _ = CS.write_temp_checkpoint(torch, name, cfg, tensors_of(cfg))
        try:
            for quantize in ("", "int4"):
                llm = CS.serving_llm(path, False, quantize=quantize)
                model = llm._handler.engine.model
                tok = llm._handler.tokenizer
                ps = CS.prompts()
                ids = [tok.encode(ps[0])[:200], tok.encode(ps[5])]
                prefill, n_pages = CS.batch_inputs(torch, [(t, 0, len(t) + 1) for t in ids])
                decode, _ = CS.batch_inputs(torch, [([7 + i], len(t), len(t) + 1) for i, t in enumerate(ids)])
                args = (prefill, decode, sum(len(t) for t in ids), len(ids), n_pages)
                swaps = {"all": (True, True, "")}
                if quantize:
                    swaps.update(attention=(True, False, ""), quant=(False, True, ""),
                                 all_dequant=(True, True, "dequant"))
                out = {}
                with torch.inference_mode():
                    plain = {v: logits(model, *args, False, False, v) for v in {s[2] for s in swaps.values()}}
                    for swap, (attn_k, quant_k, variant) in swaps.items():
                        got = logits(model, *args, attn_k, quant_k, variant)
                        out[swap] = {batch: dict(max_abs=(g - w).abs().max().item(), mean_abs=(g - w).abs().mean().item())
                                     for batch, g, w in zip(("prefill", "decode"), got, plain[variant])}
                CS.emit(dict(phase="logits_drift", model=name, layers=layers, quantize=quantize or None,
                             init="flat (N(0, 0.02))", logits_std=plain[""][1].std().item(), **out,
                             card=card["nvidia_smi"]))
                model = None
                CS.close_llm(torch, card, f"logits_drift_{name}_{layers}_{quantize or 'bf16'}", llm)
        finally:
            shutil.rmtree(path, ignore_errors=True)


if __name__ == "__main__":
    main()
