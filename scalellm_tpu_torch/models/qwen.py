"""Qwen (v1) family (counterpart of scalellm_tpu/models/qwen.py): the HF
config.json -> ModelArgs loader and the checkpoint weight-name mapping; the
chat template is ChatML (models/qwen2.py). Qwen v1's c_attn is already q|k|v
along its output dim, so it goes to qkv_proj (and its bias to qkv_bias) as
it is. Its MLP computes c_proj(w1(x) * silu(w2(x))): w2 is the gate and w1
the up projection (reference: qwen.h:64-65), and the checkpoint's
intermediate_size is twice the FFN width. The compute graph is
models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict, List

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry

_P = r"(?:transformer\.)?"
_H = _P + r"h\.(\d+)\."
QWEN_WEIGHT_RULES: List[tuple] = [
    (_P + r"wte\.weight", "embed_tokens"),
    (_H + r"ln_1\.weight", "layers.{}.input_norm"),
    (_H + r"attn\.c_attn\.weight", "layers.{}.qkv_proj"),
    (_H + r"attn\.c_attn\.bias", "layers.{}.qkv_bias"),
    (_H + r"attn\.c_proj\.weight", "layers.{}.o_proj"),
    (_H + r"ln_2\.weight", "layers.{}.post_norm"),
    (_H + r"mlp\.w1\.weight", "layers.{}.up_proj"),
    (_H + r"mlp\.w2\.weight", "layers.{}.gate_proj"),
    (_H + r"mlp\.c_proj\.weight", "layers.{}.down_proj"),
    (_P + r"ln_f\.weight", "final_norm"),
    (r"lm_head\.weight", "lm_head"),
]


@ModelRegistry.register_model_args("qwen")
def load_qwen_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: qwen.h REGISTER_MODEL_ARGS; intermediate_size // 2
    because the checkpoint stores the doubled FFN width)"""
    return ModelArgs(
        model_type="qwen",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 4096),
        hidden_act="silu",
        intermediate_size=cfg.get("intermediate_size", 22016) // 2,
        n_layers=cfg.get("num_hidden_layers", 32),
        n_heads=cfg.get("num_attention_heads", 32),
        n_kv_heads=cfg.get("num_attention_heads", 32),
        vocab_size=cfg.get("vocab_size", 151936),
        rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-6),
        rope_theta=cfg.get("rotary_emb_base", 10000.0),
        max_position_embeddings=cfg.get("max_position_embeddings", 8192),
        eos_token_id=cfg.get("eos_token_id", 151643),
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        norm_type="rms_norm",
        qkv_bias=True,
        raw=cfg,
    )


@ModelRegistry.register_causal_lm("qwen")
def create_qwen(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = QWEN_WEIGHT_RULES
    return model
