"""Multi-LoRA adapter loading (HF PEFT format): a copy of
scalellm_tpu/lora/loader.py that reads the adapter's safetensors with the
port's own reader (model_loader/loader.py:read_safetensors).

Adapters load at engine init into per-layer stacked arrays:

  lora_<target>: (A [L, n_slots, K, r_max], B [L, n_slots, r_max, N]), f32

Slot 0 is the base model (all-zero delta); adapter i lives in slot i + 1.
Adapters of different rank zero-pad to r_max (zero A columns / B rows
contribute nothing). The per-adapter lora_alpha / r scaling folds into B at
load, so the runtime delta is exactly x @ A @ B, selected per token by a
one-hot mask over the slots (models/common.py: DecoderModel.set_lora and
its forward).

PEFT tensor names:
  base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight  [r, K]
  base_model.model.model.layers.{i}.self_attn.q_proj.lora_B.weight  [N, r]
(torch convention; transposed here to A [K, r], B [r, N]).
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# target module -> (K dim, N dim) resolver keys used for shape checks
SUPPORTED_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)

_NAME_RE = re.compile(
    r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_(A|B)\.weight$"
)


@dataclass
class LoraMeta:
    names: List[str]  # adapter names; slot = index + 1 (0 = base)
    targets: Tuple[str, ...]  # union of target modules across adapters
    n_slots: int  # adapters + 1
    r_max: int

    def slot_of(self, name: str) -> int:
        return self.names.index(name) + 1


def _read_adapter(path: str):
    """Returns (config dict, {(layer, target, 'A'|'B'): np.ndarray})."""
    import torch

    from scalellm_tpu_torch.model_loader.loader import read_safetensors

    cfg_path = os.path.join(path, "adapter_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    if cfg.get("peft_type", "LORA").upper() != "LORA":
        raise ValueError(f"unsupported peft_type {cfg.get('peft_type')!r}")
    weights = {}
    wpath = os.path.join(path, "adapter_model.safetensors")
    for name, t in read_safetensors(wpath):
        m = _NAME_RE.search(name)
        if m is None:
            raise ValueError(
                f"unsupported LoRA tensor {name!r} (only decoder-layer "
                f"q/k/v/o/gate/up/down targets are supported)"
            )
        layer, target, ab = int(m.group(1)), m.group(2), m.group(3)
        if target not in SUPPORTED_TARGETS:
            raise ValueError(f"unsupported LoRA target {target!r}")
        # f32 and f16 keep their type, as the reference reads them; numpy
        # has no bf16, which widens to f32 exactly. The copy outlives the
        # file's map.
        if t.dtype not in (torch.float32, torch.float16):
            t = t.float()
        weights[(layer, target, ab)] = t.numpy().copy()
    return cfg, weights


def lora_dims(a) -> Dict[str, Tuple[int, int]]:
    """target -> (K dim, N dim) of a model's projections, from its
    ModelArgs."""
    return {
        "q_proj": (a.hidden_size, a.n_heads * a.head_dim),
        "k_proj": (a.hidden_size, a.n_kv_heads * a.head_dim),
        "v_proj": (a.hidden_size, a.n_kv_heads * a.head_dim),
        "o_proj": (a.n_heads * a.head_dim, a.hidden_size),
        "gate_proj": (a.hidden_size, a.intermediate_size),
        "up_proj": (a.hidden_size, a.intermediate_size),
        "down_proj": (a.intermediate_size, a.hidden_size),
    }


def load_lora_adapters(
    modules: Dict[str, str], model, tp_size: int = 1
) -> Tuple[Dict[str, tuple], LoraMeta]:
    """Load {name: path} adapters into the stacked runtime layout, with the
    widths of `model`'s ModelArgs.

    Returns (layer-param entries {"lora_q_proj": (A, B), ...} as f32 numpy
    arrays, LoraMeta)."""
    assert modules
    if tp_size > 1:
        raise ValueError("LoRA adapters require tp_size == 1 (use data-"
                         "parallel replicas for multi-chip LoRA serving)")
    if model.args.vocab_size >= (1 << 24):
        # prefix-cache keys salt the adapter slot into bits 24+ of token ids
        raise ValueError("vocab too large for LoRA prefix-cache salting")
    L = model.args.n_layers
    dims = lora_dims(model.args)

    names = list(modules.keys())
    adapters = []  # (scaling, weights dict, targets set, r)
    targets: set = set()
    r_max = 0
    for name in names:
        cfg, weights = _read_adapter(modules[name])
        r = int(cfg["r"])
        scaling = float(cfg.get("lora_alpha", r)) / r
        tgts = {t for (_, t, _) in weights.keys()}
        targets |= tgts
        r_max = max(r_max, r)
        adapters.append((scaling, weights, tgts, r))
        logger.info("lora %r: r=%d alpha=%s targets=%s",
                    name, r, cfg.get("lora_alpha"), sorted(tgts))

    n_slots = len(names) + 1
    out: Dict[str, tuple] = {}
    for t in sorted(targets):
        K, N = dims[t]
        A = np.zeros((L, n_slots, K, r_max), np.float32)
        B = np.zeros((L, n_slots, r_max, N), np.float32)
        for i, (scaling, weights, tgts, r) in enumerate(adapters):
            if t not in tgts:
                continue
            for layer in range(L):
                wa = weights.get((layer, t, "A"))
                wb = weights.get((layer, t, "B"))
                if wa is None and wb is None:
                    continue  # adapter may cover a subset of layers
                if wa is None or wb is None:
                    raise ValueError(
                        f"lora layer {layer} target {t}: A/B pair incomplete"
                    )
                if wa.shape != (r, K) or wb.shape != (N, r):
                    raise ValueError(
                        f"lora {t} layer {layer}: got A{wa.shape} B{wb.shape},"
                        f" expected A({r},{K}) B({N},{r})"
                    )
                A[layer, i + 1, :, :r] = np.ascontiguousarray(wa.T)
                B[layer, i + 1, :r, :] = (
                    np.ascontiguousarray(wb.T) * scaling
                )
        out[f"lora_{t}"] = (A, B)

    meta = LoraMeta(
        names=names, targets=tuple(sorted(targets)),
        n_slots=n_slots, r_max=r_max,
    )
    return out, meta
