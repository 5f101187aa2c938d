"""Qwen2-MoE family, qwen1.5-moe / qwen2-57b-a14b (counterpart of
scalellm_tpu/models/qwen2_moe.py): the HF config.json -> ModelArgs loader
and the checkpoint weight-name mapping. Top-k routed experts plus an
always-on shared expert scaled by a learned sigmoid gate, and a qkv bias.
Every layer is an MoE layer: HF's decoder_sparse_step and mlp_only_layers
are ignored, as the reference ignores them. The compute graph is
models/common.py:DecoderModel; the shared expert takes the dense FFN's
parameter names (gate_up_proj, down_proj).
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry

_A = r"model\.layers\.(\d+)\."
QWEN2_MOE_WEIGHT_RULES: List[tuple] = [
    (r"model\.embed_tokens\.weight", "embed_tokens"),
    (_A + r"self_attn\.q_proj\.weight", "layers.{}.q_proj"),
    (_A + r"self_attn\.k_proj\.weight", "layers.{}.k_proj"),
    (_A + r"self_attn\.v_proj\.weight", "layers.{}.v_proj"),
    (_A + r"self_attn\.q_proj\.bias", "layers.{}.q_bias"),
    (_A + r"self_attn\.k_proj\.bias", "layers.{}.k_bias"),
    (_A + r"self_attn\.v_proj\.bias", "layers.{}.v_bias"),
    (_A + r"self_attn\.o_proj\.weight", "layers.{}.o_proj"),
    (_A + r"mlp\.gate\.weight", "layers.{}.router"),
    (_A + r"mlp\.experts\.(\d+)\.gate_proj\.weight", "layers.{}.experts_gate.{}"),
    (_A + r"mlp\.experts\.(\d+)\.up_proj\.weight", "layers.{}.experts_up.{}"),
    (_A + r"mlp\.experts\.(\d+)\.down_proj\.weight", "layers.{}.experts_down.{}"),
    (_A + r"mlp\.shared_expert\.gate_proj\.weight", "layers.{}.gate_proj"),
    (_A + r"mlp\.shared_expert\.up_proj\.weight", "layers.{}.up_proj"),
    (_A + r"mlp\.shared_expert\.down_proj\.weight", "layers.{}.down_proj"),
    (_A + r"mlp\.shared_expert_gate\.weight", "layers.{}.shared_gate"),
    (_A + r"input_layernorm\.weight", "layers.{}.input_norm"),
    (_A + r"post_attention_layernorm\.weight", "layers.{}.post_norm"),
    (r"model\.norm\.weight", "final_norm"),
    (r"lm_head\.weight", "lm_head"),
]


@ModelRegistry.register_model_args("qwen2_moe")
def load_qwen2_moe_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    return ModelArgs(
        model_type="qwen2_moe",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 2048),
        hidden_act=cfg.get("hidden_act", "silu"),
        intermediate_size=cfg.get("intermediate_size", 5632),
        n_layers=cfg.get("num_hidden_layers", 24),
        n_heads=cfg.get("num_attention_heads", 16),
        n_kv_heads=cfg.get("num_key_value_heads"),
        vocab_size=cfg.get("vocab_size", 151936),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 1e6),
        max_position_embeddings=cfg.get("max_position_embeddings", 32768),
        eos_token_id=cfg.get("eos_token_id", 151643),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        norm_type="rms_norm",
        qkv_bias=True,
        n_experts=cfg.get("num_experts", 60),
        n_experts_per_token=cfg.get("num_experts_per_tok", 4),
        moe_intermediate_size=cfg.get("moe_intermediate_size", 1408),
        moe_shared_intermediate=cfg.get("shared_expert_intermediate_size", 5632),
        norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
        raw=cfg,
    )


@ModelRegistry.register_causal_lm("qwen2_moe")
def create_qwen2_moe(args: ModelArgs, attn_impl=None, device="cpu") -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device)
    model.hf_weight_rules = QWEN2_MOE_WEIGHT_RULES
    return model
