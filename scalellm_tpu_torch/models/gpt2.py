"""GPT-2 family (counterpart of scalellm_tpu/models/gpt2.py): learned
positional embeddings (no rope), LayerNorm with biases, a fused c_attn qkv,
an ungated gelu_new MLP, biases on every projection, tied word embeddings.
A float32 checkpoint is served in float32 (the reference's dtype rule). The
compute graph is models/common.py:DecoderModel.

GPT-2's Conv1D stores its weights as [in, out]; this model's are [out, in],
so each projection's rule transposes (the reference's [in, out] layout
needs none). c_attn's output dim is already q | k | v.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry


def _conv1d(w: torch.Tensor) -> torch.Tensor:
    """A Conv1D weight [in, out] in torch's Linear layout [out, in]."""
    return w.T


_P = r"(?:transformer\.)?"
_H = _P + r"h\.(\d+)\."
GPT2_WEIGHT_RULES: List[tuple] = [
    (_P + r"wte\.weight", "embed_tokens"),
    (_P + r"wpe\.weight", "embed_positions"),
    (_H + r"ln_1\.weight", "layers.{}.input_norm"),
    (_H + r"ln_1\.bias", "layers.{}.input_norm_bias"),
    (_H + r"attn\.c_attn\.weight", "layers.{}.qkv_proj", _conv1d),
    (_H + r"attn\.c_attn\.bias", "layers.{}.qkv_bias"),
    (_H + r"attn\.c_proj\.weight", "layers.{}.o_proj", _conv1d),
    (_H + r"attn\.c_proj\.bias", "layers.{}.o_bias"),
    (_H + r"ln_2\.weight", "layers.{}.post_norm"),
    (_H + r"ln_2\.bias", "layers.{}.post_norm_bias"),
    (_H + r"mlp\.c_fc\.weight", "layers.{}.up_proj", _conv1d),
    (_H + r"mlp\.c_fc\.bias", "layers.{}.up_bias"),
    (_H + r"mlp\.c_proj\.weight", "layers.{}.down_proj", _conv1d),
    (_H + r"mlp\.c_proj\.bias", "layers.{}.down_bias"),
    (_P + r"ln_f\.weight", "final_norm"),
    (_P + r"ln_f\.bias", "final_norm_bias"),
]


@ModelRegistry.register_model_args("gpt2")
def load_gpt2_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: gpt2.h REGISTER_MODEL_ARGS)"""
    hidden = cfg.get("n_embd", 768)
    return ModelArgs(
        model_type="gpt2",
        dtype=hf_dtype(cfg, "float32"),
        hidden_size=hidden,
        hidden_act=cfg.get("activation_function", "gelu_new"),
        intermediate_size=cfg.get("n_inner") or 4 * hidden,
        n_layers=cfg.get("n_layer", 12),
        n_heads=cfg.get("n_head", 12),
        n_kv_heads=cfg.get("n_head", 12),
        vocab_size=cfg.get("vocab_size", 50257),
        layer_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
        max_position_embeddings=cfg.get("n_positions", 1024),
        bos_token_id=cfg.get("bos_token_id", 50256),
        eos_token_id=cfg.get("eos_token_id", 50256),
        tie_word_embeddings=True,
        pos_embedding_type="learned",
        norm_type="layer_norm",
        norm_bias=True,
        qkv_bias=True,
        o_proj_bias=True,
        mlp_bias=True,
        mlp_gated=False,
        raw=cfg,
    )


@ModelRegistry.register_causal_lm("gpt2")
def create_gpt2(args: ModelArgs, attn_impl=None, device="cpu") -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device)
    model.hf_weight_rules = GPT2_WEIGHT_RULES
    return model
