"""Mixtral MoE family (counterpart of scalellm_tpu/models/mixtral.py): the
HF config.json -> ModelArgs loader and the checkpoint weight-name mapping.
Every layer is an MoE layer of num_local_experts experts, top-k routed with
the top-k weights renormalised (HF Mixtral's router), and no shared expert.
The compute graph is models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry

# HF checkpoint name -> this model's state_dict name ({} the layer, then the
# expert). The loader fuses q/k/v and copies each expert into its slot of
# the stacked [E, ...] parameter.
_A = r"model\.layers\.(\d+)\."
MIXTRAL_WEIGHT_RULES: List[tuple] = [
    (r"model\.embed_tokens\.weight", "embed_tokens"),
    (_A + r"self_attn\.q_proj\.weight", "layers.{}.q_proj"),
    (_A + r"self_attn\.k_proj\.weight", "layers.{}.k_proj"),
    (_A + r"self_attn\.v_proj\.weight", "layers.{}.v_proj"),
    (_A + r"self_attn\.o_proj\.weight", "layers.{}.o_proj"),
    (_A + r"block_sparse_moe\.gate\.weight", "layers.{}.router"),
    (_A + r"block_sparse_moe\.experts\.(\d+)\.w1\.weight", "layers.{}.experts_gate.{}"),
    (_A + r"block_sparse_moe\.experts\.(\d+)\.w3\.weight", "layers.{}.experts_up.{}"),
    (_A + r"block_sparse_moe\.experts\.(\d+)\.w2\.weight", "layers.{}.experts_down.{}"),
    (_A + r"input_layernorm\.weight", "layers.{}.input_norm"),
    (_A + r"post_attention_layernorm\.weight", "layers.{}.post_norm"),
    (r"model\.norm\.weight", "final_norm"),
    (r"lm_head\.weight", "lm_head"),
]


@ModelRegistry.register_model_args("mixtral")
def load_mixtral_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    return ModelArgs(
        model_type="mixtral",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 4096),
        hidden_act=cfg.get("hidden_act", "silu"),
        intermediate_size=cfg.get("intermediate_size", 14336),
        n_layers=cfg.get("num_hidden_layers", 32),
        n_heads=cfg.get("num_attention_heads", 32),
        n_kv_heads=cfg.get("num_key_value_heads"),
        vocab_size=cfg.get("vocab_size", 32000),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 1e6),
        max_position_embeddings=cfg.get("max_position_embeddings", 32768),
        bos_token_id=cfg.get("bos_token_id", 1),
        eos_token_id=cfg.get("eos_token_id", 2),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        sliding_window=cfg.get("sliding_window"),
        norm_type="rms_norm",
        n_experts=cfg.get("num_local_experts", 8),
        n_experts_per_token=cfg.get("num_experts_per_tok", 2),
        moe_intermediate_size=cfg.get("intermediate_size", 14336),
        norm_topk_prob=True,  # HF Mixtral renormalises the top-k router weights
        raw=cfg,
    )


@ModelRegistry.register_causal_lm("mixtral")
def create_mixtral(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = MIXTRAL_WEIGHT_RULES
    return model
