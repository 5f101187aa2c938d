"""BLOOM family (bigscience bloom-560m ... 176b; counterpart of
scalellm_tpu/models/bloom.py): ALiBi attention, a LayerNorm on the word
embeddings (word_embeddings_layernorm), LayerNorm with biases everywhere,
an ungated tanh-gelu MLP, tied word embeddings, and a fused
query_key_value whose output rows are interleaved per head ([n_heads, 3,
head_dim]): the rules reorder them to q | k | v at load
(BloomAttentionImpl::reshape_qkv_tensor in the reference). The compute
graph is models/common.py:DecoderModel.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.models.common import DecoderModel
from scalellm_tpu_torch.models.registry import ModelRegistry


@ModelRegistry.register_model_args("bloom")
def load_bloom_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    """(reference: models/bloom.py load_bloom_model_args)"""
    hidden = cfg.get("hidden_size") or cfg.get("n_embed", 64)
    return ModelArgs(
        model_type="bloom",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=hidden,
        hidden_act="gelu_pytorch_tanh",  # HF BloomGelu is the tanh form
        intermediate_size=4 * hidden,
        n_layers=cfg.get("n_layer", 2),
        n_heads=cfg.get("n_head", 8),
        n_kv_heads=cfg.get("n_head", 8),  # MHA
        vocab_size=cfg.get("vocab_size", 250880),
        layer_norm_eps=float(cfg.get("layer_norm_epsilon", 1e-5)),
        # No position embeddings: the context is not bounded by a table.
        max_position_embeddings=cfg.get("seq_length", 2048),
        bos_token_id=cfg.get("bos_token_id", 1),
        eos_token_id=cfg.get("eos_token_id", 2),
        tie_word_embeddings=True,  # BLOOM always ties lm_head to the embeddings
        pos_embedding_type="alibi",
        norm_type="layer_norm",
        norm_bias=True,
        embedding_norm=True,
        qkv_bias=True,
        o_proj_bias=True,
        mlp_bias=True,
        mlp_gated=False,
        raw=cfg,
    )


def _uninterleave(n_heads: int, head_dim: int):
    """query_key_value's rows [n_heads, 3, head_dim] (weight [rows, hidden],
    or the bias [rows]) reordered to [3, n_heads, head_dim]: q | k | v."""

    def t(w: torch.Tensor) -> torch.Tensor:
        rest = w.shape[1:]
        return w.reshape(n_heads, 3, head_dim, *rest).transpose(0, 1).reshape(3 * n_heads * head_dim, *rest)

    return t


@ModelRegistry.register_causal_lm("bloom")
def create_bloom(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> DecoderModel:
    model = DecoderModel(args, attn_impl, device=device, **parallel)
    P = r"(?:transformer\.)?"
    H = P + r"h\.(\d+)\."
    qkv = _uninterleave(args.n_heads, args.head_dim)
    model.hf_weight_rules = [
        (P + r"word_embeddings\.weight", "embed_tokens"),
        (P + r"word_embeddings_layernorm\.weight", "embed_norm"),
        (P + r"word_embeddings_layernorm\.bias", "embed_norm_bias"),
        (H + r"input_layernorm\.weight", "layers.{}.input_norm"),
        (H + r"input_layernorm\.bias", "layers.{}.input_norm_bias"),
        (H + r"self_attention\.query_key_value\.weight", "layers.{}.qkv_proj", qkv),
        (H + r"self_attention\.query_key_value\.bias", "layers.{}.qkv_bias", qkv),
        (H + r"self_attention\.dense\.weight", "layers.{}.o_proj"),
        (H + r"self_attention\.dense\.bias", "layers.{}.o_bias"),
        (H + r"post_attention_layernorm\.weight", "layers.{}.post_norm"),
        (H + r"post_attention_layernorm\.bias", "layers.{}.post_norm_bias"),
        (H + r"mlp\.dense_h_to_4h\.weight", "layers.{}.up_proj"),
        (H + r"mlp\.dense_h_to_4h\.bias", "layers.{}.up_bias"),
        (H + r"mlp\.dense_4h_to_h\.weight", "layers.{}.down_proj"),
        (H + r"mlp\.dense_4h_to_h\.bias", "layers.{}.down_bias"),
        (P + r"ln_f\.weight", "final_norm"),
        (P + r"ln_f\.bias", "final_norm_bias"),
        (r"lm_head\.weight", "lm_head"),
    ]
    return model
