"""HuggingFace model-folder loader
(counterpart of scalellm_tpu/model_loader/loader.py:HFModelLoader).

Reads config.json through the registry's per-model args loader and the
model's *.safetensors files, one tensor at a time, straight into the model's
state_dict on the target device, cast to the model's compute dtype. A
model's weight rule is (regex, target) or (regex, target, transform): the
transform re-lays the cast tensor out (GPT-2's Conv1D weights [in, out]
transposed, BLOOM's per-head interleaved query_key_value reordered). The
safetensors format is read here without the safetensors package: an 8-byte
little-endian header length, a JSON header naming each tensor's dtype, shape
and byte range, then the raw bytes (read with torch.frombuffer over a
memory map). F32, F16, BF16, I32 and I64 tensors are supported. Every
parameter and buffer of the model must be filled, or loading fails.

A checkpoint with a quantization_config (or a quantize_config.json beside it)
is an AWQ or GPTQ checkpoint: its projections are read through the rules of
quantization/linear.py, whose transforms unpack qweight / qzeros into the
kernel layout with torch ops on the target device. Under GPTQ desc_act each
projection's rows are sorted into contiguous groups and the permutation is
kept for the input gather. A model that asks for a quantized lm_head gets it
quantized here from the checkpoint's dense one. A rule whose target has one
more index than a parameter of the model (the experts of an MoE layer,
"layers.{}.experts_gate.{}") fills that slot of the stacked parameter; a
slot the checkpoint lacks is a load error.

An int8-KV model's per-layer KV scales (kv_scales [L, 2]) are no checkpoint
tensor: they come from a kv_scales.json sidecar beside the checkpoint
({"k": [...], "v": [...]}, written by eval/kv_calibration.py), else from
ModelArgs.kv_scale.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import re
import struct
from typing import Any, Dict, Iterator, Tuple

import torch

from scalellm_tpu_torch.config import ModelArgs, QuantArgs, TokenizerArgs
from scalellm_tpu_torch.models.common import FUSED_PROJECTIONS
from scalellm_tpu_torch.models.registry import ModelRegistry
from scalellm_tpu_torch.ops.quant_matmul import (
    pack_int4,
    quantize_linear,
    to_kernel_layout,
    unpack_int4,
)
from scalellm_tpu_torch.quantization.linear import build_quant_rules

logger = logging.getLogger(__name__)

SAFETENSORS_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "I64": torch.int64,
}


def read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) for every tensor of a .safetensors file. Each
    tensor is a view of a private copy-on-write memory map that lives until
    the caller drops the tensor; copy it before keeping it."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        if os.fstat(f.fileno()).st_size == 8 + header_len:
            mm = None  # no tensor bytes (mmap refuses an empty range)
        else:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    data_start = 8 + header_len
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(
                f"{path}: tensor {name} has dtype {info['dtype']} "
                f"(supported: {sorted(SAFETENSORS_DTYPES)})"
            )
        begin, end = info["data_offsets"]
        shape = info["shape"]
        numel = 1
        for n in shape:
            numel *= n
        if numel * dtype.itemsize != end - begin:
            raise ValueError(f"{path}: tensor {name} byte range does not match its shape")
        if numel == 0:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(mm, dtype=dtype, count=numel, offset=data_start + begin)
        yield name, flat.view(shape)


class HFModelLoader:
    def __init__(self, model_path: str):
        if not os.path.isdir(model_path):
            raise ValueError(f"not a model folder: {model_path}")
        self.model_path = model_path
        with open(os.path.join(model_path, "config.json")) as f:
            self.hf_config: Dict[str, Any] = json.load(f)
        self.model_type = self.hf_config.get("model_type", "")

        loader = ModelRegistry.get_model_args_loader(self.model_type)
        if loader is None:
            raise ValueError(
                f"unsupported model type {self.model_type!r}; supported: "
                f"{ModelRegistry.supported_model_types()}"
            )
        self.model_args: ModelArgs = loader(self.hf_config)

        qcfg = dict(self.hf_config)
        for name in ("quantize_config.json", "quant_config.json"):
            p = os.path.join(model_path, name)
            if os.path.exists(p) and "quantization_config" not in qcfg:
                with open(p) as f:
                    qcfg["quantization_config"] = json.load(f)
                break
        self.quant_args = QuantArgs.from_hf_config(qcfg)
        self.model_args.quant_args = self.quant_args if self.quant_args.enabled else None
        self.tokenizer_args = self._load_tokenizer_args()
        self.weight_files = sorted(
            os.path.join(model_path, f)
            for f in os.listdir(model_path)
            if f.endswith(".safetensors")
        )

    def _load_tokenizer_args(self) -> TokenizerArgs:
        args = TokenizerArgs()
        tc_path = os.path.join(self.model_path, "tokenizer_config.json")
        if os.path.exists(tc_path):
            with open(tc_path) as f:
                args.chat_template = json.load(f).get("chat_template")
        return args

    def load_state_dict(self, model: torch.nn.Module, device) -> Dict[str, torch.Tensor]:
        """Read every checkpoint tensor the model's weight rules name onto
        `device` (floating tensors cast to the model's dtype, quantized ones
        through their rule's transform), with fused projections
        concatenated."""
        dense = [(rule[0], rule[1], rule[2] if len(rule) > 2 else None) for rule in model.hf_weight_rules]
        rules = build_quant_rules(dense, self.quant_args) if self.quant_args.enabled else dense
        # A model's own rule (cast) reads its tensor in the model's dtype and
        # then applies its layout transform; a quantized tensor's rule hands
        # the raw tensor to its format transform.
        rules = [(re.compile(rx + r"$"), target, fn, (rx, target, fn) in dense) for rx, target, fn in rules]
        expected = dict(model.state_dict(keep_vars=True))
        dtype = model.dtype
        parts: Dict[str, torch.Tensor] = {}
        sd: Dict[str, torch.Tensor] = {}
        stacked: Dict[str, set] = {}  # stacked parameter -> the slots filled
        unmatched = []
        for wf in self.weight_files:
            for ckpt_name, raw in read_safetensors(wf):
                for rx, target, transform, cast in rules:
                    m = rx.match(ckpt_name)
                    if m is not None:
                        name = target.format(*m.groups())
                        if name == "lm_head" and self.model_args.tie_word_embeddings:
                            break
                        stack, _, slot = name.rpartition(".")
                        if transform is None and name not in expected and stack in expected:
                            # One expert of an [E, ...] parameter, copied into its slot.
                            self._fill_slot(sd, stacked, stack, int(slot), expected[stack], raw, device)
                            break
                        if cast:
                            t = raw.to(device=device, dtype=dtype, copy=True)
                            if transform is not None:
                                t = transform(t).contiguous()
                        else:
                            t = transform(raw.to(device=device, copy=True))
                        (sd if name in expected else parts)[name] = t
                        break
                else:
                    unmatched.append(ckpt_name)
                del raw
        if unmatched:
            logger.warning(
                "%d checkpoint tensors matched no weight rule (e.g. %s)",
                len(unmatched), ", ".join(unmatched[:5]),
            )
        for name in expected:
            if name in sd:
                continue
            prefix, _, leaf = name.rpartition(".")
            if leaf == "perm" and f"{prefix}.g_idx" in parts:
                # GPTQ desc_act: sort the rows into contiguous groups.
                perm = torch.argsort(parts.pop(f"{prefix}.g_idx"), stable=True)
                rows = unpack_int4(sd[f"{prefix}.qweight"].T)[perm]
                sd[f"{prefix}.qweight"] = to_kernel_layout(pack_int4(rows))
                sd[name] = perm.to(torch.int32)
                continue
            if prefix == "lm_head" and leaf == "qweight" and "lm_head" in parts:
                lm = model.lm_head
                sd[name], sd["lm_head.scales"] = quantize_linear(
                    parts.pop("lm_head"), lm.bits, lm.group_size)
                continue
            # A fused projection: its parts concatenated along the output
            # dim, which is dim 0 of a weight or qweight and dim 1 of scales
            # and zeros.
            module, tensor_leaf = (prefix, leaf) if leaf not in FUSED_PROJECTIONS else (name, "")
            stem, _, fused = module.rpartition(".")
            if fused not in FUSED_PROJECTIONS:
                continue
            names = [".".join(filter(None, (stem, p, tensor_leaf))) for p in FUSED_PROJECTIONS[fused]]
            if all(n in parts for n in names):
                dim = 1 if tensor_leaf in ("scales", "zeros") else 0
                sd[name] = torch.cat([parts.pop(n) for n in names], dim=dim)
        for stack, slots in stacked.items():
            absent = sorted(set(range(expected[stack].shape[0])) - slots)
            if absent:
                raise ValueError(f"{stack}: the checkpoint lacks slots {absent[:8]} (experts)")
        if "kv_scales" in expected:
            sd["kv_scales"] = self.kv_scales(expected["kv_scales"].shape[0]).to(device)
        missing = [n for n in expected if n not in sd]
        if missing:
            raise ValueError(f"weights not fully loaded for: {missing[:8]}")
        for name, param in expected.items():
            if sd[name].shape != param.shape or sd[name].dtype != param.dtype:
                raise ValueError(
                    f"{name}: checkpoint {tuple(sd[name].shape)} {sd[name].dtype} "
                    f"!= model {tuple(param.shape)} {param.dtype}"
                )
        return sd

    def kv_scales(self, n_layers: int) -> torch.Tensor:
        """The int8 KV cache's per-layer [k_scale, v_scale], f32 [L, 2]: the
        calibration sidecar kv_scales.json where the folder has one, else
        ModelArgs.kv_scale everywhere."""
        sidecar = os.path.join(self.model_path, "kv_scales.json")
        if not os.path.exists(sidecar):
            return torch.full((n_layers, 2), self.model_args.kv_scale, dtype=torch.float32)
        with open(sidecar) as f:
            data = json.load(f)
        scales = torch.tensor([data["k"], data["v"]], dtype=torch.float32).T.contiguous()
        if scales.shape != (n_layers, 2):
            raise ValueError(f"{sidecar}: scales {tuple(scales.shape)} for a model of {n_layers} layers")
        logger.info("loaded calibrated kv scales from %s", sidecar)
        return scales

    @staticmethod
    def _fill_slot(sd, stacked, stack, slot, param, raw, device) -> None:
        """Copy one checkpoint tensor into slot `slot` of the stacked
        parameter `stack` (allocated on the device at its first slot)."""
        if stack not in sd:
            sd[stack] = torch.empty(param.shape, dtype=param.dtype, device=device)
            stacked[stack] = set()
        if not 0 <= slot < param.shape[0] or tuple(raw.shape) != tuple(param.shape[1:]):
            raise ValueError(f"{stack}[{slot}]: checkpoint {tuple(raw.shape)} does not fit "
                             f"{tuple(param.shape)}")
        sd[stack][slot].copy_(raw)
        stacked[stack].add(slot)

    def load_model(self, model: torch.nn.Module, device) -> torch.nn.Module:
        """Fill a model built on the meta device with the checkpoint; the
        buffers it builds itself (rope tables) go to the same device."""
        model.load_state_dict(self.load_state_dict(model, device), assign=True)
        return model.to(device)
