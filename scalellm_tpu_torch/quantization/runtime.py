"""Runtime quantization of a dense model (counterpart of
scalellm_tpu/quantization/runtime.py, the dense-decoder part): the model's
projections, and its lm_head when asked, are group-quantized on the device
they lie on, so any bf16 checkpoint can be served in INT4 or INT8.
"""

from __future__ import annotations

import copy

import torch

from scalellm_tpu_torch.config import QuantArgs
from scalellm_tpu_torch.ops.quant_matmul import quantize_linear


def quantize_model(dense_model, quant: QuantArgs):
    """A new model whose args carry `quant`, with every quantized buffer
    computed from the dense model's weight of the same name. The dense
    model's tensors are shared where they are kept (embeddings, norms)."""
    args = copy.copy(dense_model.args)
    if args.n_experts > 0:
        raise NotImplementedError("runtime quantization of MoE experts is not ported")
    args.quant_args = quant
    qmodel = type(dense_model)(args, dense_model.attn_impl, device="meta")
    qmodel.hf_weight_rules = getattr(dense_model, "hf_weight_rules", None)

    dense = dense_model.state_dict()
    modules = dict(qmodel.named_modules())
    sd = {}
    for name, spec in qmodel.state_dict().items():
        prefix, _, leaf = name.rpartition(".")
        if leaf == "qweight":
            m = modules[prefix]
            qw, scales = quantize_linear(dense[prefix], m.bits, m.group_size)
            sd[name], sd[prefix + ".scales"] = qw, scales
        elif leaf != "scales" or prefix not in dense:
            sd[name] = dense[name]
        if name in sd and sd[name].shape != spec.shape:
            raise ValueError(f"{name}: {tuple(sd[name].shape)} != {tuple(spec.shape)}")
    with torch.no_grad():
        qmodel.load_state_dict(sd, assign=True)
    return qmodel
