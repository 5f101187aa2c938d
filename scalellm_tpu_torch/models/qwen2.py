"""Qwen2 / Qwen2.5 and Qwen3 families (counterpart of
scalellm_tpu/models/qwen2.py): Qwen2 is Llama-shaped with a qkv bias; Qwen3
drops the bias and adds an RMSNorm of each head's q and k over head_dim
(the qk norm) and an explicit head_dim. Both, and Qwen v1 (models/qwen.py),
use the ChatML template. The compute graph is models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.llama import LLAMA_WEIGHT_RULES
from scalellm_tpu_torch.models.registry import ModelRegistry

QWEN3_EXTRA_RULES: List[tuple] = [
    (r"model\.layers\.(\d+)\.self_attn\.q_norm\.weight", "layers.{}.q_norm"),
    (r"model\.layers\.(\d+)\.self_attn\.k_norm\.weight", "layers.{}.k_norm"),
]


@ModelRegistry.register_model_args("qwen2")
def load_qwen2_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: qwen2.h REGISTER_MODEL_ARGS)"""
    use_sliding = bool(cfg.get("use_sliding_window", False))
    return ModelArgs(
        model_type="qwen2",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 3584),
        hidden_act=cfg.get("hidden_act", "silu"),
        intermediate_size=cfg.get("intermediate_size", 18944),
        n_layers=cfg.get("num_hidden_layers", 28),
        n_heads=cfg.get("num_attention_heads", 28),
        n_kv_heads=cfg.get("num_key_value_heads"),
        vocab_size=cfg.get("vocab_size", 152064),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 1000000.0),
        max_position_embeddings=cfg.get("max_position_embeddings", 32768),
        bos_token_id=cfg.get("bos_token_id", 151643),
        eos_token_id=cfg.get("eos_token_id", 151645),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        sliding_window=cfg.get("sliding_window") if use_sliding else None,
        norm_type="rms_norm",
        qkv_bias=True,
        raw=cfg,
    )


@ModelRegistry.register_model_args("qwen3")
def load_qwen3_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    args = load_qwen2_model_args(cfg)
    args.model_type = "qwen3"
    args.qkv_bias = False
    args.use_qk_norm = True
    args.head_dim = cfg.get("head_dim", 128)
    return args


@ModelRegistry.register_causal_lm("qwen2")
def create_qwen2(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = LLAMA_WEIGHT_RULES
    return model


@ModelRegistry.register_causal_lm("qwen3")
def create_qwen3(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = LLAMA_WEIGHT_RULES + QWEN3_EXTRA_RULES
    return model


@ModelRegistry.register_chat_template("qwen", "qwen2", "qwen3")
def chatml_template(messages) -> str:
    """ChatML (reference: qwen2.h chat template registration)."""
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m.role}\n{m.content}<|im_end|>\n")
    out.append("<|im_start|>assistant\n")
    return "".join(out)
