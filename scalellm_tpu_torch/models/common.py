"""Decoder-only transformer, the Llama subset of
scalellm_tpu/models/common.py:DecoderModel.

Embedding -> per layer (RMSNorm, fused qkv projection, rope, in-place KV
scatter, ragged paged attention, o projection, RMSNorm, fused gate/up
projection, gated activation, down projection) -> final RMSNorm; logits()
applies the lm_head. Weights are nn.Parameters in torch's [out, in] layout,
with q/k/v fused into qkv_proj and gate/up into gate_up_proj as in the
reference's fused layout. The layers run as a Python loop; the attention
implementation is a hook (attn_impl) so a caller can swap the kernel for the
plain version.

Features of the reference's DecoderModel that this subset does not carry
(quantized projections, MoE, LoRA, tensor/sequence parallelism, int8 KV,
biases, layer norm, ALiBi, qk-norm, parallel residual) raise
NotImplementedError when the model args ask for them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from scalellm_tpu_torch.config import ModelArgs
from scalellm_tpu_torch.engine.params import ModelInputs
from scalellm_tpu_torch.layers.activations import act_with_mul
from scalellm_tpu_torch.layers.norms import rms_norm
from scalellm_tpu_torch.layers.rope import apply_rope, compute_cos_sin
from scalellm_tpu_torch.ops.attention import ragged_paged_attention
from scalellm_tpu_torch.ops.kv_update import set_kv_cache

# Fused weight -> the checkpoint projections concatenated (in order) along
# the output dim.
FUSED_PROJECTIONS = {
    "qkv_proj": ("q_proj", "k_proj", "v_proj"),
    "gate_up_proj": ("gate_proj", "up_proj"),
}


def model_dtype(args: ModelArgs) -> torch.dtype:
    """Compute dtype: float16 and float32 checkpoints run as bfloat16 unless
    the model dtype is float32 (the reference executor's casting rule)."""
    return {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.bfloat16,
    }[args.dtype]


def _unsupported(args: ModelArgs) -> List[str]:
    checks = {
        "quantized weights": args.quant_args is not None and args.quant_args.enabled,
        "MoE": args.n_experts > 0,
        "MLA": args.kv_lora_rank > 0,
        "int8 KV cache": args.kv_cache_dtype != "auto",
        "layer norm": args.norm_type != "rms_norm",
        "non-rope positions": args.pos_embedding_type != "rope",
        "biases": args.qkv_bias or args.o_proj_bias or args.mlp_bias
        or args.lm_head_bias or args.norm_bias,
        "qk norm": args.use_qk_norm,
        "parallel residual": args.parallel_residual,
        "post-block norms": args.residual_post_layernorm,
        "ungated MLP": not args.mlp_gated,
        "embedding norm": args.embedding_norm,
        "qkv clip": args.qkv_clip > 0,
    }
    return [name for name, on in checks.items() if on]


def _param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    def __init__(self, args: ModelArgs, dtype: torch.dtype, device):
        super().__init__()
        D, F_, Dh = args.hidden_size, args.intermediate_size, args.head_dim
        H, Hkv = args.n_heads, args.n_kv_heads
        self.input_norm = _param(D, dtype=dtype, device=device)
        self.qkv_proj = _param((H + 2 * Hkv) * Dh, D, dtype=dtype, device=device)
        self.o_proj = _param(D, H * Dh, dtype=dtype, device=device)
        self.post_norm = _param(D, dtype=dtype, device=device)
        self.gate_up_proj = _param(2 * F_, D, dtype=dtype, device=device)
        self.down_proj = _param(D, F_, dtype=dtype, device=device)


class DecoderModel(nn.Module):
    """A causal LM: embedding -> decoder layers -> norm -> lm_head."""

    def __init__(self, args: ModelArgs, attn_impl=None, device="cpu"):
        super().__init__()
        missing = _unsupported(args)
        if missing:
            raise NotImplementedError(
                f"{args.model_type}: not ported: {', '.join(missing)}"
            )
        self.args = args
        self.attn_impl = attn_impl or ragged_paged_attention
        self.dtype = model_dtype(args)
        D, V = args.hidden_size, args.vocab_size
        self.embed_tokens = _param(V, D, dtype=self.dtype, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(args, self.dtype, device) for _ in range(args.n_layers)
        )
        self.final_norm = _param(D, dtype=self.dtype, device=device)
        if not args.tie_word_embeddings:
            self.lm_head = _param(V, D, dtype=self.dtype, device=device)

    # ------------------------------------------------------------ kv cache

    def kv_cache_shape(self, num_pages: int, page_size: int):
        """[L, P, page, 2 * Hkv, Dh], K at even and V at odd combined heads."""
        a = self.args
        return (a.n_layers, num_pages, page_size, 2 * a.n_kv_heads, a.head_dim)

    # ------------------------------------------------------------ forward

    def _sm_scale(self) -> float:
        a = self.args
        if a.attn_scalar is not None:
            return a.attn_scalar
        if a.query_pre_attn_scalar > 0:
            return a.query_pre_attn_scalar ** -0.5
        return a.head_dim ** -0.5

    def _layer_windows(self) -> List[Optional[int]]:
        """Per-layer sliding windows (gemma2-style alternation by pattern)."""
        a = self.args
        if not a.sliding_window:
            return [None] * a.n_layers
        pattern = max(a.sliding_window_pattern, 1)
        return [
            a.sliding_window if (i % pattern != pattern - 1 or pattern == 1) else None
            for i in range(a.n_layers)
        ]

    def forward(
        self,
        kv_cache: torch.Tensor,  # [L, P, page, 2*Hkv, Dh], updated in place
        mi: ModelInputs,
        all_hidden: bool = False,
    ) -> torch.Tensor:
        """Returns the final hidden states of the selected rows [S, D] (all
        rows [T, D] with all_hidden). The KV cache is written in place."""
        a = self.args
        H, Hkv, Dh = a.n_heads, a.n_kv_heads, a.head_dim
        q_n, kv_n = H * Dh, Hkv * Dh
        sm_scale = self._sm_scale()
        soft_cap = a.attn_logit_soft_cap if a.attn_logit_soft_cap > 0 else None

        h = self.embed_tokens[mi.token_ids]  # [T, D]
        if a.normalize_embedding:
            h = (h.float() * math.sqrt(a.hidden_size)).to(h.dtype)
        cos, sin = compute_cos_sin(a, mi.positions)
        T = h.shape[0]

        for layer, kvc, window in zip(self.layers, kv_cache, self._layer_windows()):
            x = rms_norm(h, layer.input_norm, a.rms_norm_eps, a.zero_centered_norm)
            q, k, v = F.linear(x, layer.qkv_proj).split([q_n, kv_n, kv_n], dim=-1)
            q = apply_rope(q.reshape(T, H, Dh), cos, sin, a.interleaved_rope)
            k = apply_rope(k.reshape(T, Hkv, Dh), cos, sin, a.interleaved_rope)
            set_kv_cache(kvc, k, v.reshape(T, Hkv, Dh), mi.new_kv_slot_ids)
            o = self.attn_impl(
                q.contiguous(), kvc, mi.kv_lens, mi.block_tables, mi.cu_q_lens,
                mi.num_seqs, sm_scale=sm_scale, sliding_window=window,
                logit_soft_cap=soft_cap,
            )
            h = h + F.linear(o.reshape(T, q_n), layer.o_proj)

            x = rms_norm(h, layer.post_norm, a.rms_norm_eps, a.zero_centered_norm)
            g, u = F.linear(x, layer.gate_up_proj).chunk(2, dim=-1)
            m = act_with_mul(a.hidden_act, g.float(), u.float()).to(x.dtype)
            h = h + F.linear(m, layer.down_proj)

        h = rms_norm(h, self.final_norm, a.rms_norm_eps, a.zero_centered_norm)
        if all_hidden:
            return h
        return h[mi.selected_idxes]

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[S, D] -> [S, V] float32 logits."""
        a = self.args
        w = self.embed_tokens if a.tie_word_embeddings else self.lm_head
        logits = F.linear(hidden, w).float()
        if a.final_logit_soft_cap > 0.0:
            cap = a.final_logit_soft_cap
            logits = cap * torch.tanh(logits / cap)
        return logits


def convert_params(jax_params: Dict, args: ModelArgs) -> Dict[str, torch.Tensor]:
    """The reference package's numpy parameter tree (fused layout, per-layer
    tensors stacked over L, projections [in, out]) -> this model's
    state_dict (per-layer tensors, projections [out, in]), on the CPU."""
    import numpy as np

    def tensor(x) -> torch.Tensor:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(arr.copy())

    layers = jax_params["layers"]
    sd = {
        "embed_tokens": tensor(jax_params["embed_tokens"]),
        "final_norm": tensor(jax_params["final_norm"]),
    }
    if not args.tie_word_embeddings:
        sd["lm_head"] = tensor(jax_params["lm_head"]).T.contiguous()
    projections = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
    for l in range(args.n_layers):
        for name in ("input_norm", "post_norm") + projections:
            t = tensor(np.asarray(layers[name])[l])
            sd[f"layers.{l}.{name}"] = t.T.contiguous() if name in projections else t
    return sd
