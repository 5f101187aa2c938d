"""Phi family: phi-1 / phi-1.5 / phi-2 (counterpart of
scalellm_tpu/models/phi.py): a parallel residual (attention and MLP read
one LayerNorm's output and both add into the residual), a partial rotary
embedding (partial_rotary_factor of each head; Phi-2: 32 of 80 dims),
biases on every projection and on the untied lm_head, an ungated gelu_new
MLP. The compute graph is models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry

_A = r"model\.layers\.(\d+)\."
PHI_WEIGHT_RULES: List[tuple] = [
    (r"model\.embed_tokens\.weight", "embed_tokens"),
    (_A + r"self_attn\.q_proj\.weight", "layers.{}.q_proj"),
    (_A + r"self_attn\.k_proj\.weight", "layers.{}.k_proj"),
    (_A + r"self_attn\.v_proj\.weight", "layers.{}.v_proj"),
    (_A + r"self_attn\.q_proj\.bias", "layers.{}.q_bias"),
    (_A + r"self_attn\.k_proj\.bias", "layers.{}.k_bias"),
    (_A + r"self_attn\.v_proj\.bias", "layers.{}.v_bias"),
    (_A + r"self_attn\.dense\.weight", "layers.{}.o_proj"),
    (_A + r"self_attn\.dense\.bias", "layers.{}.o_bias"),
    (_A + r"mlp\.fc1\.weight", "layers.{}.up_proj"),
    (_A + r"mlp\.fc1\.bias", "layers.{}.up_bias"),
    (_A + r"mlp\.fc2\.weight", "layers.{}.down_proj"),
    (_A + r"mlp\.fc2\.bias", "layers.{}.down_bias"),
    (_A + r"input_layernorm\.weight", "layers.{}.input_norm"),
    (_A + r"input_layernorm\.bias", "layers.{}.input_norm_bias"),
    (r"model\.final_layernorm\.weight", "final_norm"),
    (r"model\.final_layernorm\.bias", "final_norm_bias"),
    (r"lm_head\.weight", "lm_head"),
    (r"lm_head\.bias", "lm_head_bias"),
]


@ModelRegistry.register_model_args("phi")
def load_phi_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: phi.h REGISTER_MODEL_ARGS; the defaults are Phi-1.5's)"""
    return ModelArgs(
        model_type="phi",
        dtype=hf_dtype(cfg, "float16"),
        hidden_size=cfg.get("hidden_size", 2048),
        hidden_act=cfg.get("hidden_act", "gelu_new"),
        intermediate_size=cfg.get("intermediate_size", 8192),
        n_layers=cfg.get("num_hidden_layers", 24),
        n_heads=cfg.get("num_attention_heads", 32),
        n_kv_heads=cfg.get("num_key_value_heads") or cfg.get("num_attention_heads", 32),
        vocab_size=cfg.get("vocab_size", 51200),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rotary_pct=float(cfg.get("partial_rotary_factor", 0.5)),
        max_position_embeddings=cfg.get("max_position_embeddings", 2048),
        bos_token_id=cfg.get("bos_token_id", 1),
        eos_token_id=cfg.get("eos_token_id", 2),
        tie_word_embeddings=False,
        lm_head_bias=True,
        pos_embedding_type="rope",
        norm_type="layer_norm",
        norm_bias=True,
        qkv_bias=True,
        o_proj_bias=True,
        mlp_bias=True,
        mlp_gated=False,
        parallel_residual=True,
        raw=cfg,
    )


@ModelRegistry.register_causal_lm("phi")
def create_phi(args: ModelArgs, attn_impl=None, device="cpu") -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device)
    model.hf_weight_rules = PHI_WEIGHT_RULES
    return model
