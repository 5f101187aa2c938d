"""Gemma family (counterpart of scalellm_tpu/models/gemma.py): the HF
config.json -> ModelArgs loader, the checkpoint weight-name mapping and the
<start_of_turn> chat template. Gemma: zero-centred (1 + w) RMSNorm,
embeddings scaled by sqrt(hidden_size), a gated tanh-GELU MLP, always-tied
word embeddings and an explicit head_dim. The compute graph is
models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry

# HF checkpoint name -> this model's state_dict name ({} is the layer index).
# No lm_head: the embeddings are always tied.
_A = r"model\.layers\.(\d+)\."
GEMMA_WEIGHT_RULES: List[tuple] = [
    (r"model\.embed_tokens\.weight", "embed_tokens"),
    (_A + r"self_attn\.q_proj\.weight", "layers.{}.q_proj"),
    (_A + r"self_attn\.k_proj\.weight", "layers.{}.k_proj"),
    (_A + r"self_attn\.v_proj\.weight", "layers.{}.v_proj"),
    (_A + r"self_attn\.o_proj\.weight", "layers.{}.o_proj"),
    (_A + r"mlp\.gate_proj\.weight", "layers.{}.gate_proj"),
    (_A + r"mlp\.up_proj\.weight", "layers.{}.up_proj"),
    (_A + r"mlp\.down_proj\.weight", "layers.{}.down_proj"),
    (_A + r"input_layernorm\.weight", "layers.{}.input_norm"),
    (_A + r"post_attention_layernorm\.weight", "layers.{}.post_norm"),
    (r"model\.norm\.weight", "final_norm"),
]


@ModelRegistry.register_model_args("gemma")
def load_gemma_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: gemma.h REGISTER_MODEL_ARGS LOAD_ARG section)"""
    return ModelArgs(
        model_type="gemma",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 2048),
        # older gemma configs say "gelu" but mean the tanh approximation
        hidden_act=(
            "gelu_pytorch_tanh"
            if cfg.get("hidden_act", "gelu") in ("gelu", None)
            else cfg["hidden_act"]
        ),
        intermediate_size=cfg.get("intermediate_size", 16384),
        n_layers=cfg.get("num_hidden_layers", 18),
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
        norm_type="rms_norm",
        raw=cfg,
    )


@ModelRegistry.register_causal_lm("gemma")
def create_gemma(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = GEMMA_WEIGHT_RULES
    return model


@ModelRegistry.register_chat_template("gemma", "gemma2")
def gemma_chat_template(messages) -> str:
    """Gemma <start_of_turn> template (reference: gemma.h chat template)."""
    out = ["<bos>"]
    for m in messages:
        role = "model" if m.role == "assistant" else m.role
        out.append(f"<start_of_turn>{role}\n{m.content}<end_of_turn>\n")
    out.append("<start_of_turn>model\n")
    return "".join(out)
