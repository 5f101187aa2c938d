"""Mistral family (counterpart of scalellm_tpu/models/mistral.py):
Llama-shaped, with the sliding window of config.json (when set) on every
layer, Llama's weight names and the llama2 [INST] template. The compute
graph is models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.llama import LLAMA_WEIGHT_RULES, llama2_chat_template
from scalellm_tpu_torch.models.registry import ModelRegistry


@ModelRegistry.register_model_args("mistral")
def load_mistral_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    return ModelArgs(
        model_type="mistral",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 4096),
        hidden_act=cfg.get("hidden_act", "silu"),
        intermediate_size=cfg.get("intermediate_size", 14336),
        n_layers=cfg.get("num_hidden_layers", 32),
        n_heads=cfg.get("num_attention_heads", 32),
        n_kv_heads=cfg.get("num_key_value_heads"),
        head_dim=cfg.get("head_dim", 0) or 0,
        vocab_size=cfg.get("vocab_size", 32000),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        max_position_embeddings=cfg.get("max_position_embeddings", 32768),
        bos_token_id=cfg.get("bos_token_id", 1),
        eos_token_id=cfg.get("eos_token_id", 2),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        sliding_window=cfg.get("sliding_window"),
        sliding_window_pattern=1,  # every layer slides when a window is set
        norm_type="rms_norm",
        raw=cfg,
    )


@ModelRegistry.register_causal_lm("mistral")
def create_mistral(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = LLAMA_WEIGHT_RULES
    return model


ModelRegistry.register_chat_template("mistral")(llama2_chat_template)
