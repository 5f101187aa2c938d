"""Gemma2 family (counterpart of scalellm_tpu/models/gemma2.py). Gemma2 adds
to Gemma: sliding-window attention on even layers and global attention on
odd ones, attention and final logit soft caps, query_pre_attn_scalar as the
softmax scale, and post-block norms (post_attention / pre_feedforward /
post_feedforward layernorms). The compute graph is
models/common.py:DecoderModel; the chat template is Gemma's.
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.gemma import GEMMA_WEIGHT_RULES
from scalellm_tpu_torch.models.registry import ModelRegistry

# HF gemma2's "post_attention_layernorm" normalises the attention output
# before the residual add; "pre_feedforward_layernorm" is the MLP's pre-norm
# (the post_norm slot).
_A = r"model\.layers\.(\d+)\."
GEMMA2_WEIGHT_RULES: List[tuple] = [
    rule for rule in GEMMA_WEIGHT_RULES if "post_attention" not in rule[0]
] + [
    (_A + r"post_attention_layernorm\.weight", "layers.{}.post_attn_norm"),
    (_A + r"pre_feedforward_layernorm\.weight", "layers.{}.post_norm"),
    (_A + r"post_feedforward_layernorm\.weight", "layers.{}.post_ffw_norm"),
]


@ModelRegistry.register_model_args("gemma2")
def load_gemma2_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: gemma2.h REGISTER_MODEL_ARGS; sliding window + soft caps
    per model_args.h:98-101,125-127)"""
    return ModelArgs(
        model_type="gemma2",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 2304),
        hidden_act=cfg.get("hidden_activation", "gelu_pytorch_tanh") or "gelu_pytorch_tanh",
        intermediate_size=cfg.get("intermediate_size", 9216),
        n_layers=cfg.get("num_hidden_layers", 26),
        n_heads=cfg.get("num_attention_heads", 8),
        n_kv_heads=cfg.get("num_key_value_heads"),
        head_dim=cfg.get("head_dim", 256),
        vocab_size=cfg.get("vocab_size", 256000),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        max_position_embeddings=cfg.get("max_position_embeddings", 8192),
        bos_token_id=cfg.get("bos_token_id", 2),
        eos_token_id=cfg.get("eos_token_id", 1),
        tie_word_embeddings=True,
        normalize_embedding=True,
        zero_centered_norm=True,
        residual_post_layernorm=True,
        norm_type="rms_norm",
        query_pre_attn_scalar=float(cfg.get("query_pre_attn_scalar", 256)),
        sliding_window=cfg.get("sliding_window", 4096),
        sliding_window_pattern=2,  # even layers sliding (HF: layer_idx % 2 == 0)
        attn_logit_soft_cap=float(cfg.get("attn_logit_softcapping") or 0.0),
        final_logit_soft_cap=float(cfg.get("final_logit_softcapping") or 0.0),
        raw=cfg,
    )


@ModelRegistry.register_causal_lm("gemma2")
def create_gemma2(args: ModelArgs, attn_impl=None, device="cpu") -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device)
    model.hf_weight_rules = GEMMA2_WEIGHT_RULES
    return model
