"""Calibration of the int8 KV cache's per-layer scales
(counterpart of scalellm_tpu/eval/kv_calibration.py).

Replaces the global ModelArgs.kv_scale with per-layer [k_scale, v_scale]
measured on calibration text: a float-KV twin of the model (the same
weights, kv_cache_dtype "auto") runs the calibration windows through its
normal forward (on the card: K1 on bf16 pages), and the K and V values are
read straight out of the paged cache it wrote, which is the record of every
layer's K and V. scale = amax / 127, so nothing clips at int8.

DecoderModel only: DeepSeek's latent pages take the static ModelArgs.kv_scale,
and neither package calibrates them.

CLI (the card by default; --cpu runs on the CPU):
  python -m scalellm_tpu_torch.eval.kv_calibration --model <dir> --text <file> \
      [--out <dir>/kv_scales.json] [--window 512] [--max-tokens 4096] [--cpu]
writes the sidecar kv_scales.json ({"k": [...], "v": [...]}) that the loader
reads when the model is served with kv_cache_dtype="int8".
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import numpy as np
import torch

from scalellm_tpu_torch.eval.ppl import _window_inputs, window_cache


def float_kv_twin(model):
    """The model with a float KV cache over the same tensors (no copy)."""
    args = copy.copy(model.args)
    args.kv_cache_dtype = "auto"
    twin = type(model)(args, model.attn_impl, device="meta")
    sd = {k: v for k, v in model.state_dict().items() if k != "kv_scales"}
    twin.load_state_dict(sd, assign=True)
    for name, buf in model.named_buffers():  # the tables outside the state_dict (rope, ALiBi)
        if name not in sd and name != "kv_scales":
            setattr(twin, name, buf)
    twin.quant_impl, twin.gmm_impl, twin.qexperts_impl = model.quant_impl, model.gmm_impl, model.qexperts_impl
    return twin


@torch.inference_mode()
def calibrate_kv_scales(model, token_ids, window: int = 512, page_size: int = 16) -> torch.Tensor:
    """Per-layer [k_scale, v_scale], f32 [L, 2] on the CPU, from running a
    float-KV twin of `model` over `token_ids` in windows."""
    if not hasattr(model, "kv_scales"):
        raise ValueError(f"{model.args.model_type}: no per-layer KV scales to calibrate (DeepSeek's latent "
                         "cache takes the static ModelArgs.kv_scale)")
    twin = float_kv_twin(model)
    device = twin.embed_tokens.device
    base = _window_inputs(window, page_size).to(device)
    kv = window_cache(twin, window, page_size)  # [L, P, page, 2 * Hkv, Dh], K even / V odd
    L = model.args.n_layers
    k_max = torch.zeros(L, dtype=torch.float32, device=device)
    v_max = torch.zeros(L, dtype=torch.float32, device=device)
    token_ids = np.asarray(token_ids, dtype=np.int32)
    for start in range(0, max(len(token_ids) - 1, 1), window):
        chunk = token_ids[start : start + window]
        if len(chunk) < 2:
            break
        if len(chunk) < window:
            chunk = np.pad(chunk, (0, window - len(chunk)))
        kv.zero_()  # unwritten slots stay 0 and cannot raise the amax
        twin(kv, dataclasses.replace(base, token_ids=torch.from_numpy(chunk).to(device)))
        k_max = torch.maximum(k_max, kv[:, :, :, 0::2].float().abs().amax(dim=(1, 2, 3, 4)))
        v_max = torch.maximum(v_max, kv[:, :, :, 1::2].float().abs().amax(dim=(1, 2, 3, 4)))
    scales = torch.stack([k_max, v_max], dim=1) / 127.0
    return scales.clamp_min(1e-6).cpu()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--text", required=True)
    p.add_argument("--out", default="", help="default: <model>/kv_scales.json")
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=4096)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)

    from scalellm_tpu_torch.eval.ppl import load_for_eval
    from scalellm_tpu_torch.tokenizer.tokenizer import load_tokenizer

    tok = load_tokenizer(args.model, None)
    with open(args.text, encoding="utf-8") as f:
        ids = np.asarray(tok.encode(f.read()), dtype=np.int32)[: args.max_tokens]

    model = load_for_eval(args.model, kv_cache_dtype="int8", device="cpu" if args.cpu else "cuda")
    scales = calibrate_kv_scales(model, ids, window=args.window)
    out = args.out or os.path.join(args.model, "kv_scales.json")
    with open(out, "w") as f:
        json.dump({"k": scales[:, 0].tolist(), "v": scales[:, 1].tolist()}, f)
    result = {"out": out, "k_mean": float(scales[:, 0].mean()), "v_mean": float(scales[:, 1].mean())}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
