"""Llama model family: llama/llama2/llama3/Yi (+ TinyLlama etc.).

Counterpart of scalellm_tpu/models/llama.py: the HF config.json -> ModelArgs
loader, the checkpoint weight-name mapping and the coded chat templates. The
compute graph is models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry


@ModelRegistry.register_model_args("llama", "llama2", "llama3", "Yi")
def load_llama_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: llama.h REGISTER_MODEL_ARGS LOAD_ARG section)"""
    rope_scaling = cfg.get("rope_scaling") or {}
    return ModelArgs(
        model_type="llama",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 4096),
        hidden_act=cfg.get("hidden_act", "silu"),
        intermediate_size=cfg.get("intermediate_size", 11008),
        n_layers=cfg.get("num_hidden_layers", 32),
        n_heads=cfg.get("num_attention_heads", 32),
        n_kv_heads=cfg.get("num_key_value_heads"),
        head_dim=cfg.get("head_dim", 0) or 0,
        vocab_size=cfg.get("vocab_size", 32000),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rope_scaling_factor=float(rope_scaling.get("factor", 0.0) or 0.0),
        rope_scaling_rope_type=rope_scaling.get("rope_type", rope_scaling.get("type", "")) or "",
        rope_scaling_low_freq_factor=float(rope_scaling.get("low_freq_factor", 1.0)),
        rope_scaling_high_freq_factor=float(rope_scaling.get("high_freq_factor", 4.0)),
        rope_scaling_original_max_position_embeddings=int(
            rope_scaling.get("original_max_position_embeddings", 8192)
        ),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        bos_token_id=cfg.get("bos_token_id", 1),
        eos_token_id=cfg.get("eos_token_id", 2),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        norm_type="rms_norm",
        qkv_bias=cfg.get("attention_bias", False),
        raw=cfg,
    )


# HF checkpoint name -> this model's state_dict name ({} is the layer index).
# Checkpoint weights are already in torch's [out, in] layout. The loader
# fuses q/k/v, their biases and gate/up (models/common.py FUSED_PROJECTIONS).
LLAMA_WEIGHT_RULES: List[tuple] = [
    (r"model\.embed_tokens\.weight", "embed_tokens"),
    (r"model\.layers\.(\d+)\.self_attn\.q_proj\.weight", "layers.{}.q_proj"),
    (r"model\.layers\.(\d+)\.self_attn\.k_proj\.weight", "layers.{}.k_proj"),
    (r"model\.layers\.(\d+)\.self_attn\.v_proj\.weight", "layers.{}.v_proj"),
    (r"model\.layers\.(\d+)\.self_attn\.o_proj\.weight", "layers.{}.o_proj"),
    # The qkv biases (attention_bias; qwen2), fused into qkv_bias.
    (r"model\.layers\.(\d+)\.self_attn\.q_proj\.bias", "layers.{}.q_bias"),
    (r"model\.layers\.(\d+)\.self_attn\.k_proj\.bias", "layers.{}.k_bias"),
    (r"model\.layers\.(\d+)\.self_attn\.v_proj\.bias", "layers.{}.v_bias"),
    (r"model\.layers\.(\d+)\.mlp\.gate_proj\.weight", "layers.{}.gate_proj"),
    (r"model\.layers\.(\d+)\.mlp\.up_proj\.weight", "layers.{}.up_proj"),
    (r"model\.layers\.(\d+)\.mlp\.down_proj\.weight", "layers.{}.down_proj"),
    (r"model\.layers\.(\d+)\.input_layernorm\.weight", "layers.{}.input_norm"),
    (r"model\.layers\.(\d+)\.post_attention_layernorm\.weight", "layers.{}.post_norm"),
    (r"model\.norm\.weight", "final_norm"),
    (r"lm_head\.weight", "lm_head"),
]


@ModelRegistry.register_causal_lm("llama", "llama2", "llama3", "Yi")
def create_llama(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = LLAMA_WEIGHT_RULES
    return model


@ModelRegistry.register_chat_template("llama", "llama2")
def llama2_chat_template(messages) -> str:
    """Coded llama2 [INST] template (reference: common_chat_template.h:13)."""
    parts = []
    system = ""
    for m in messages:
        if m.role == "system":
            system = m.content
    first = True
    for m in messages:
        if m.role == "user":
            content = m.content
            if first and system:
                content = f"<<SYS>>\n{system}\n<</SYS>>\n\n{content}"
            first = False
            parts.append(f"[INST] {content} [/INST]")
        elif m.role == "assistant":
            parts.append(f" {m.content} ")
    return "".join(parts)


@ModelRegistry.register_chat_template("llama3")
def llama3_chat_template(messages) -> str:
    """Coded llama3 header template (reference: common_chat_template.h:21)."""
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(f"<|start_header_id|>{m.role}<|end_header_id|>\n\n{m.content}<|eot_id|>")
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)
