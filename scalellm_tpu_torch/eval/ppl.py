"""Perplexity harness: the teacher-forced NLL of a checkpoint over a text file
(counterpart of scalellm_tpu/eval/ppl.py).

Quantized serving is held to the bf16 model's perplexity at the same
weights: the INT4/INT8 variants come from the runtime quantizer
(quantization/runtime.py) and the int8 KV cache from kv_cache_dtype, as the
serving engine builds them.

Scoring is windowed (stride = window): the token stream is cut into
independent windows of `window` tokens and each window is scored with one
prefill step through the model's normal forward (on the card: K1, or K10 for
DeepSeek), logits at every position. No context crosses a window.

CLI (the card by default; --cpu runs on the CPU):
  python -m scalellm_tpu_torch.eval.ppl --model <dir> --text <file> \
      [--quantize int4|int8] [--kv-cache-dtype int8] [--calibrate-kv] \
      [--quantize-lm-head int8|int4] [--window 512] [--max-tokens 65536] \
      [--dtype float32] [--cpu]
prints one JSON line: {"ppl": ..., "nll": ..., "tokens": N, ...}.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from scalellm_tpu_torch.engine.params import ModelInputs


def _window_inputs(T: int, page_size: int) -> ModelInputs:
    """One sequence of T tokens at positions 0..T-1, its KV in pages 1.. of
    the window's cache (page 0 is the reserved padding page), every row's
    hidden state selected; token ids are filled per window."""
    n_pages = T // page_size + 1
    return ModelInputs(
        token_ids=torch.zeros(T, dtype=torch.int32),
        positions=torch.arange(T, dtype=torch.int32),
        token_seg=torch.zeros(T, dtype=torch.int32),
        new_kv_slot_ids=torch.arange(T, dtype=torch.int32) + page_size,
        block_tables=torch.arange(1, n_pages + 1, dtype=torch.int32)[None],
        kv_lens=torch.tensor([T], dtype=torch.int32),
        cu_q_lens=torch.tensor([0, T], dtype=torch.int32),
        num_seqs=torch.tensor([1], dtype=torch.int32),
        selected_idxes=torch.arange(T, dtype=torch.int32),
        seq_mask=torch.ones(1, dtype=torch.float32),
    )


def window_cache(model, window: int, page_size: int) -> torch.Tensor:
    """A zero KV cache for one window, in the model's KV type (int8 pages
    for an int8-KV model), on the model's device."""
    return torch.zeros(model.kv_cache_shape(window // page_size + 2, page_size), dtype=model.kv_cache_dtype(),
                       device=model.embed_tokens.device)


def make_window_scorer(model, window: int, page_size: int = 16) -> Callable[[Any, int], Tuple[float, float]]:
    """scorer(tokens[window], n_valid) -> (sum of NLL, positions scored): one
    prefill of the window on a fresh cache, the next-token NLL at positions
    0 .. n_valid - 2."""
    device = model.embed_tokens.device
    base = _window_inputs(window, page_size).to(device)
    kv = window_cache(model, window, page_size)
    mask = torch.arange(window - 1, device=device)

    @torch.inference_mode()
    def scorer(tokens, n_valid: int) -> Tuple[float, float]:
        ids = torch.as_tensor(np.asarray(tokens, np.int32)).to(device)
        kv.zero_()
        mi = dataclasses.replace(base, token_ids=ids)
        logits = model.logits(model(kv, mi, all_hidden=True))  # [T, V] f32
        logp = torch.log_softmax(logits[:-1].float(), dim=-1)
        nll = -logp.gather(1, ids[1:].long()[:, None])[:, 0]
        valid = (mask < n_valid - 1).float()
        return float((nll * valid).sum()), float(valid.sum())

    return scorer


def perplexity(model, token_ids, window: int = 512, page_size: int = 16,
               progress: bool = False) -> Dict[str, Any]:
    """Strided perplexity of `token_ids` under `model`."""
    token_ids = np.asarray(token_ids, dtype=np.int32)
    scorer = make_window_scorer(model, window, page_size)
    total_nll, total_n = 0.0, 0.0
    for start in range(0, len(token_ids) - 1, window):
        chunk = token_ids[start : start + window]
        n_valid = len(chunk)
        if n_valid < 2:
            break
        if n_valid < window:
            chunk = np.pad(chunk, (0, window - n_valid))
        nll, n = scorer(chunk, n_valid)
        total_nll += nll
        total_n += n
        if progress:
            print(f"  scored {start + n_valid}/{len(token_ids)} tokens "
                  f"(running ppl {np.exp(total_nll / total_n):.4f})", flush=True)
    mean_nll = total_nll / max(total_n, 1.0)
    return {"ppl": float(np.exp(mean_nll)), "nll": float(mean_nll), "tokens": int(total_n)}


def load_for_eval(
    model_dir: str,
    quantize: str = "",
    kv_cache_dtype: str = "auto",
    quantize_lm_head: "bool | str" = False,
    calibrate_kv: bool = False,
    calib_tokens: Optional[np.ndarray] = None,
    dtype: str = "",
    device: str = "cuda",
):
    """The model for scoring, on `device`, with runtime quantization, the
    int8 KV cache and its calibration applied as the serving engine applies
    them."""
    import scalellm_tpu_torch.models  # noqa: F401  (registers the models)
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for and CUDA is not available")
    loader = HFModelLoader(model_dir)
    args = loader.model_args
    if dtype:
        args.dtype = dtype
    if kv_cache_dtype != "auto":
        args.kv_cache_dtype = kv_cache_dtype
    factory = ModelRegistry.get_causal_lm_factory(loader.model_type)
    model = loader.load_model(factory(args, device="meta"), torch.device(device))
    if quantize and not (args.quant_args and args.quant_args.enabled):
        from scalellm_tpu_torch.config import QuantArgs
        from scalellm_tpu_torch.quantization.runtime import quantize_model

        qargs = QuantArgs(quant_method="internal", bits=4 if quantize == "int4" else 8, group_size=128,
                          quantize_lm_head=quantize_lm_head)
        model = quantize_model(model, qargs)
    if calibrate_kv and model.kv_quant:
        from scalellm_tpu_torch.eval.kv_calibration import calibrate_kv_scales

        if calib_tokens is None:
            raise ValueError("calibrate_kv needs calib_tokens")
        model.kv_scales.copy_(calibrate_kv_scales(model, calib_tokens))
    return model


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--text", required=True, help="UTF-8 text file to score")
    p.add_argument("--quantize", default="", choices=["", "int4", "int8"])
    p.add_argument("--kv-cache-dtype", default="auto", choices=["auto", "int8"])
    p.add_argument("--quantize-lm-head", default="", choices=["", "int8", "int4"])
    p.add_argument("--calibrate-kv", action="store_true")
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=65536)
    p.add_argument("--dtype", default="", help="override the model dtype")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)

    from scalellm_tpu_torch.tokenizer.tokenizer import load_tokenizer

    tok = load_tokenizer(args.model, None)
    with open(args.text, encoding="utf-8") as f:
        text = f.read()
    ids = np.asarray(tok.encode(text), dtype=np.int32)[: args.max_tokens]

    lm_head = {"": False, "int8": True, "int4": "int4"}[args.quantize_lm_head]
    model = load_for_eval(
        args.model,
        quantize=args.quantize,
        kv_cache_dtype=args.kv_cache_dtype,
        quantize_lm_head=lm_head,
        calibrate_kv=args.calibrate_kv,
        calib_tokens=ids[: 4 * args.window],
        dtype=args.dtype,
        device="cpu" if args.cpu else "cuda",
    )
    result = perplexity(model, ids, window=args.window, progress=True)
    result.update(
        model=args.model,
        quantize=args.quantize or "bf16",
        kv_cache_dtype=args.kv_cache_dtype,
        calibrated_kv=bool(args.calibrate_kv),
    )
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
