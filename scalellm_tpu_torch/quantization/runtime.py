"""Runtime quantization of a dense model (counterpart of
scalellm_tpu/quantization/runtime.py): the projections the quantized model
declares (QuantLinear: group-quantized, and its lm_head when asked or, for
DeepSeek, always) and its routed experts (QuantExperts: int4 per (expert,
k-group, channel) or int8 per (expert, channel)) are quantized on the
device they lie on, so any bf16 checkpoint can be served in INT4 or INT8.
An int8-KV model's per-layer KV scales carry over from the dense model (or,
where it has none, start at ModelArgs.kv_scale).
"""

from __future__ import annotations

import copy

import torch

from scalellm_tpu_torch.config import QuantArgs


def quantize_model(dense_model, quant: QuantArgs):
    """A new model whose args carry `quant`, with every quantized buffer
    computed from the dense model's weight of the same name by the module
    that holds it (QuantLinear or QuantExperts). The dense model's tensors
    are shared where they are kept (embeddings, norms, unquantized
    projections); the caller frees the rest by dropping the dense model."""
    args = copy.copy(dense_model.args)
    args.quant_args = quant
    qmodel = type(dense_model)(args, dense_model.attn_impl, device="meta")
    qmodel.hf_weight_rules = getattr(dense_model, "hf_weight_rules", None)

    dense = dense_model.state_dict()
    modules = dict(qmodel.named_modules())
    sd = {}
    for name, spec in qmodel.state_dict().items():
        prefix, _, leaf = name.rpartition(".")
        if leaf == "qweight":
            for key, t in modules[prefix].quantize(dense[prefix]).items():
                sd[f"{prefix}.{key}"] = t
        elif name == "kv_scales" and name not in dense:  # int8 KV asked of the quantized model alone
            sd[name] = torch.full(spec.shape, args.kv_scale, dtype=torch.float32,
                                  device=dense["embed_tokens"].device)
        elif leaf != "scales" or prefix not in dense:
            sd[name] = dense[name]
        if name in sd and sd[name].shape != spec.shape:
            raise ValueError(f"{name}: {tuple(sd[name].shape)} != {tuple(spec.shape)}")
    with torch.no_grad():
        qmodel.load_state_dict(sd, assign=True)
    for name, buf in dense_model.named_buffers():  # the tables outside the state_dict (rope, ALiBi)
        if name not in sd:
            setattr(qmodel, name, buf)
    return qmodel
