"""MPT family (MosaicML mpt-7b class; counterpart of
scalellm_tpu/models/mpt.py): ALiBi score biases instead of position
embeddings, a fused Wqkv (already q | k | v along its output dim), LayerNorm
without biases when no_bias (weight only), an ungated gelu MLP, tied word
embeddings, optional qkv clamping (attn_config.clip_qkv, in f32 before the
cast) and softmax_scale (the model's attn_scalar). The compute graph is
models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry


@ModelRegistry.register_model_args("mpt")
def load_mpt_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: models/mpt.py load_mpt_model_args)"""
    attn_cfg = cfg.get("attn_config") or {}
    hidden = cfg.get("d_model", 4096)
    no_bias = bool(cfg.get("no_bias", True))
    return ModelArgs(
        model_type="mpt",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=hidden,
        hidden_act="gelu",
        intermediate_size=int(cfg.get("expansion_ratio", 4)) * hidden,
        n_layers=cfg.get("n_layers", 32),
        n_heads=cfg.get("n_heads", 32),
        n_kv_heads=attn_cfg.get("kv_n_heads") or cfg.get("n_heads", 32),
        vocab_size=cfg.get("vocab_size", 50368),
        layer_norm_eps=float(cfg.get("layer_norm_epsilon", 1e-5)),
        max_position_embeddings=cfg.get("max_seq_len", 2048),
        bos_token_id=cfg.get("bos_token_id", 0),
        eos_token_id=cfg.get("eos_token_id", 0),
        tie_word_embeddings=True,  # MPT always ties lm_head to wte
        pos_embedding_type="alibi" if attn_cfg.get("alibi", True) else "none",
        qkv_clip=float(attn_cfg.get("clip_qkv") or 0.0),
        attn_scalar=attn_cfg.get("softmax_scale"),
        norm_type="layer_norm",
        norm_bias=not no_bias,
        qkv_bias=not no_bias,
        o_proj_bias=not no_bias,
        mlp_bias=not no_bias,
        mlp_gated=False,
        raw=cfg,
    )


_P = r"(?:transformer\.)?"
_B = _P + r"blocks\.(\d+)\."
MPT_WEIGHT_RULES: List[tuple] = [
    (_P + r"wte\.weight", "embed_tokens"),
    (_B + r"norm_1\.weight", "layers.{}.input_norm"),
    (_B + r"norm_1\.bias", "layers.{}.input_norm_bias"),
    (_B + r"attn\.Wqkv\.weight", "layers.{}.qkv_proj"),
    (_B + r"attn\.Wqkv\.bias", "layers.{}.qkv_bias"),
    (_B + r"attn\.out_proj\.weight", "layers.{}.o_proj"),
    (_B + r"attn\.out_proj\.bias", "layers.{}.o_bias"),
    (_B + r"norm_2\.weight", "layers.{}.post_norm"),
    (_B + r"norm_2\.bias", "layers.{}.post_norm_bias"),
    (_B + r"ffn\.up_proj\.weight", "layers.{}.up_proj"),
    (_B + r"ffn\.up_proj\.bias", "layers.{}.up_bias"),
    (_B + r"ffn\.down_proj\.weight", "layers.{}.down_proj"),
    (_B + r"ffn\.down_proj\.bias", "layers.{}.down_bias"),
    (_P + r"norm_f\.weight", "final_norm"),
    (_P + r"norm_f\.bias", "final_norm_bias"),
]


@ModelRegistry.register_causal_lm("mpt")
def create_mpt(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = MPT_WEIGHT_RULES
    return model
