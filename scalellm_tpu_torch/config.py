"""Model / quantization / tokenizer argument structs.

Equivalents of the reference's arg structs:
- ModelArgs     (reference: src/models/model_args.h:14-127, ~45 DEFINE_ARG fields)
- QuantArgs     (reference: src/layers/quantization/quant_args.h:10-33)
- TokenizerArgs (reference: src/tokenizer/tokenizer_args.h:16)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ModelArgs:
    model_type: str = ""
    dtype: str = "bfloat16"
    hidden_size: int = 4096
    hidden_act: str = "silu"
    intermediate_size: int = 11008
    n_layers: int = 32
    head_dim: int = 0  # 0 -> hidden_size // n_heads
    n_heads: int = 32
    n_kv_heads: Optional[int] = None  # None -> n_heads (MHA)
    vocab_size: int = 32000
    rms_norm_eps: float = 1e-5
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 0.0  # 0 -> disabled
    rope_scaling_rope_type: str = ""  # "", "linear", "llama3"
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_position_embeddings: int = 8192
    rotary_dim: int = 0  # 0 -> head_dim (partial rotary for phi/gpt-neox)
    rotary_pct: float = 1.0
    interleaved_rope: bool = False
    max_position_embeddings: int = 4096
    bos_token_id: int = 1
    eos_token_id: int = 2
    # position embeddings: "rope" | "learned" | "alibi" | "none"
    # (alibi: per-head linear score biases instead of embeddings —
    # reference: src/kernels/attention/common/mask.h + handler.cpp
    # create_handler_with_alibi; used by mpt/bloom-class models)
    pos_embedding_type: str = "rope"
    # mpt-style clamp of q/k/v activations to [-clip, clip] (0 = off)
    qkv_clip: float = 0.0
    # attention
    qkv_bias: bool = False
    o_proj_bias: bool = False
    mlp_bias: bool = False
    # qwen3/gemma3-style per-head-dim RMS norms on q and k
    use_qk_norm: bool = False
    attn_scalar: Optional[float] = None
    sliding_window: Optional[int] = None
    # gemma2-style: every other layer uses sliding window
    sliding_window_pattern: int = 1  # 1 = all layers sliding (if set); 2 = alternate
    attn_logit_soft_cap: float = 0.0
    final_logit_soft_cap: float = 0.0
    # embeddings
    tie_word_embeddings: bool = False
    lm_head_bias: bool = False  # phi
    normalize_embedding: bool = False  # gemma: hidden *= sqrt(hidden_size)
    # bloom: LayerNorm on the embedding output (word_embeddings_layernorm)
    embedding_norm: bool = False
    # mlp: gated (gate*act(up)) or plain fc->act->proj
    mlp_gated: bool = True
    # norms
    norm_type: str = "rms_norm"  # "rms_norm" | "layer_norm"
    norm_bias: bool = False  # layer_norm bias (gpt2/phi)
    # gemma2-style extra norms applied to block OUTPUTS before the residual
    # add (post_attn_norm / post_ffw_norm)
    residual_post_layernorm: bool = False
    # phi/gpt-neox-style parallel residual: h += attn(norm(h)) + mlp(norm(h))
    parallel_residual: bool = False
    # gemma-style (1+w) rmsnorm weights
    zero_centered_norm: bool = False
    # gemma2 extras
    query_pre_attn_scalar: float = 0.0
    # DeepSeek MLA attention (deepseek_v2)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 0  # 0 = standard attention (no MLA)
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"  # "greedy" | "group_limited_greedy"
    n_group: int = 0
    topk_group: int = 0
    # MoE (qwen-moe / mixtral / deepseek style)
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_intermediate_size: int = 0
    n_shared_experts: int = 0
    # qwen2_moe-style always-on shared expert FFN dim (0 = none); the dense
    # gate/up/down param slots hold the shared expert's weights
    moe_shared_intermediate: int = 0
    norm_topk_prob: bool = False
    # KV cache quantization: "auto" (activation dtype) | "int8"
    kv_cache_dtype: str = "auto"
    # static dequant scale for int8 KV (the attention kernel's k/v_scale)
    kv_scale: float = 0.0625
    # misc
    stop_token_ids: List[int] = field(default_factory=list)
    # weight-only quantization (set by HFModelLoader when the checkpoint
    # carries a quantization_config; see QuantArgs below)
    quant_args: Optional["QuantArgs"] = None
    # raw HF config for model-specific extras
    raw: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.n_kv_heads is None:
            self.n_kv_heads = self.n_heads
        if self.head_dim == 0:
            self.head_dim = self.hidden_size // self.n_heads

    @property
    def effective_rotary_dim(self) -> int:
        if self.rotary_dim:
            return self.rotary_dim
        return int(self.head_dim * self.rotary_pct)


@dataclass
class QuantArgs:
    """Weight-only quantization config
    (reference: src/layers/quantization/quant_args.h:10-33)."""

    quant_method: str = ""  # "", "gptq", "awq"
    bits: int = 0
    group_size: int = 0
    desc_act: bool = False
    is_sym: bool = True
    zero_point: bool = False  # awq uses zero points

    # Quantize the (checkpoint-fp16) lm_head at load time — saves its full
    # HBM read every decode step (the checkpoint formats leave the lm_head
    # unquantized). False = off (checkpoint-exact logits), True = int8,
    # "int4" = int4 (halves the read again).
    quantize_lm_head: "bool | str" = False

    @property
    def enabled(self) -> bool:
        return self.quant_method != ""

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any]) -> "QuantArgs":
        """Parse HF quantization_config / quantize_config.json
        (reference: model_loader.cpp quant config detection)."""
        q = cfg.get("quantization_config") or cfg.get("quant_config") or {}
        if not q:
            return cls()
        return cls(
            quant_method=q.get("quant_method", ""),
            bits=int(q.get("bits", q.get("w_bit", 0) or 0)),
            group_size=int(q.get("group_size", q.get("q_group_size", 0) or 0)),
            desc_act=bool(q.get("desc_act", False)),
            is_sym=bool(q.get("sym", True)),
            zero_point=bool(q.get("zero_point", False)),
        )


@dataclass
class TokenizerArgs:
    """(reference: src/tokenizer/tokenizer_args.h:16)"""

    tokenizer_type: str = "hf"  # "hf" | "tiktoken"
    vocab_file: str = ""
    chat_template: Optional[str] = None
    prefix_tokens: List[str] = field(default_factory=list)
    special_tokens: List[str] = field(default_factory=list)


def hf_dtype(cfg, default="bfloat16"):
    """transformers ≥4.56 writes "dtype"; older configs "torch_dtype"."""
    return cfg.get("torch_dtype") or cfg.get("dtype") or default
