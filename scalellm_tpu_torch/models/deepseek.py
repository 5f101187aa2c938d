"""DeepSeek-V2 family: Multi-head Latent Attention over a K-only latent page
cache, a dense first stack, then MoE layers with shared experts
(counterpart of scalellm_tpu/models/deepseek.py).

Attention runs in the absorbed formulation, as multi-query attention over
one shared latent head:
  scores = (q_nope @ W_UK) . c_kv + q_pe . k_pe,   out = (p . c_kv) @ W_UV
where W_UK and W_UV are the two halves of kv_b. The cache holds K = [c_kv |
k_pe] (kv_lora_rank + rope dims, 576 for DeepSeek-V2) per token and layer;
V is its first kv_lora_rank columns, read back by the attention op
(ops/mla_attention.py: K9 on decode-only steps, K10 otherwise). Rope runs on
the qk_rope_head_dim part in the interleaved convention, with DeepSeek's
own yarn tables when the checkpoint carries rope_scaling (the mscale factor
on cos/sin and mscale_all_dim^2 on the softmax scale).

MoE layers (from first_k_dense_replace on): softmax routing, greedy or
group-limited top-k, then routed_scaling_factor or (norm_topk_prob) a
renormalisation; the routed experts through layers/moe.py's routed_experts
(sorted dispatch and grouped GEMMs, K6, three launches a layer; the same
function serves DecoderModel's MoE families); the shared experts as one
plain gated FFN added without a gate.

Weights are nn.Parameters in torch's [out, in] layout, per layer: the dense
FFN's and the shared experts' gate/up fused into gate_up_proj, the routed
experts stacked [E, N, K] (experts_gate, experts_up, experts_down).

Runtime-quantized models (quant_args, internal quantization of a bf16
checkpoint; the reference's moe_quant and proj_quant, which on one device
always go together):
  - the routed experts are QuantExperts at quant_args.bits: int4 per
    (expert, k-group, channel), the group quant_args.group_size (128) halved
    until it divides the hidden and expert widths, or int8 per (expert,
    channel). A step of T tokens runs them through layers/moe.py's
    quant_expert_ffn: K8 for gate and up and K7 for down while T * top_k
    rows fit the decode kernel (fits_decode_kernel), else dequantized experts
    through K6. At T = 1 the reference's sort-free layout is taken whenever
    the decode kernel fits, on every device (it equals the sorted dispatch).
  - q_proj / q_b_proj, o_proj, kv_a_proj (only where its width is a multiple
    of 128; never on a real DeepSeek), the dense layer's gate_up_proj and
    down_proj, the shared experts' gate_up_proj and down_proj, and the
    lm_head are symmetric QuantLinears at the same bits wherever pick_group
    finds a group size for their input width (V2-Lite: 128 at K = 2048, 32
    at the shared experts' K = 2816, none at the dense down's K = 10944);
    the others stay bf16, as do q_a, kv_b and the router. A fused gate_up
    keeps the reference's unfused tile width, so plan() picks the same
    k-block.
Pre-quantized (GPTQ/AWQ) DeepSeek checkpoints are refused: the reference has
no such path.

The attention, the grouped matmul, the quantized matmul and the quantized
experts are hooks (attn_impl, gmm_impl, quant_impl, qexperts_impl) so a
caller can swap the kernels for their plain versions or the float
reference. The reference's MOE_DISPATCH_T1 / MOE_FUSE_GATE_UP environment
switches are not ported (both choices give the same values; the port takes
the T=1 layout and the fused pair wherever they apply), nor is its
BENCH_ABLATE.

int8 latent pages (kv_cache_dtype="int8"): the pages hold round(x / s)
clamped to [-127, 127] with the reference's static global scale s =
ModelArgs.kv_scale, and the MLA kernels read them at k_scale = s (the
reference has no per-layer latent scales and no calibration for MLA, and
neither has this model).

Not ported (each raises NotImplementedError where the model args ask for
it): tensor and expert parallelism.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scalellm_tpu_torch.config import ModelArgs, hf_dtype
from scalellm_tpu_torch.engine.params import ModelInputs
from scalellm_tpu_torch.layers.activations import act_with_mul
from scalellm_tpu_torch.layers.moe import quant_expert_ffn, routed_experts, single_token_fits
from scalellm_tpu_torch.layers.norms import rms_norm
from scalellm_tpu_torch.layers.rope import apply_rope, cos_sin, inv_freq_buffer
from scalellm_tpu_torch.models.common import (
    QuantExperts,
    QuantLinear,
    _param,
    active_quant,
    dense_f32,
    model_dtype,
)
from scalellm_tpu_torch.models.registry import ModelRegistry
from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul
from scalellm_tpu_torch.ops.mla_attention import mla_paged_attention, set_latent_cache
from scalellm_tpu_torch.ops.quant_matmul import DEFAULT_TILE_N, quant_matmul, untile_quant_layout


def parse_yarn(args: ModelArgs) -> Optional[Dict[str, float]]:
    rs = (args.raw or {}).get("rope_scaling")
    if not rs:
        return None
    rtype = rs.get("type") or rs.get("rope_type")
    if rtype != "yarn":
        raise ValueError(f"deepseek rope_scaling type {rtype!r} unsupported (only yarn)")
    return {
        "factor": float(rs.get("factor", 1.0)),
        "original_max_position_embeddings": float(rs.get("original_max_position_embeddings", 4096)),
        "beta_fast": float(rs.get("beta_fast", 32)),
        "beta_slow": float(rs.get("beta_slow", 1)),
        "mscale": float(rs.get("mscale", 1.0)),
        "mscale_all_dim": float(rs.get("mscale_all_dim", 0.0)),
    }


def yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0 or mscale == 0.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(beta_fast, beta_slow, dim, base, orig_max_pos):
    def correction_dim(num_rotations):
        return (dim * math.log(orig_max_pos / (num_rotations * 2 * math.pi))) / (2 * math.log(base))

    low = math.floor(correction_dim(beta_fast))
    high = math.ceil(correction_dim(beta_slow))
    return max(low, 0), min(high, dim - 1)


def rope_inv_freq(args: ModelArgs):
    """(inv_freq f32 [r/2], cos/sin multiplier) over qk_rope_head_dim, yarn
    blended when the checkpoint asks (HF DeepseekV2YarnRotaryEmbedding)."""
    r = args.qk_rope_head_dim
    inv_freq = 1.0 / (args.rope_theta ** (np.arange(0, r, 2, dtype=np.float64) / r))
    y = parse_yarn(args)
    if y is None:
        return inv_freq.astype(np.float32), 1.0
    low, high = yarn_correction_range(y["beta_fast"], y["beta_slow"], r, args.rope_theta,
                                      y["original_max_position_embeddings"])
    ramp = np.clip((np.arange(r // 2, dtype=np.float64) - low) / max(high - low, 1e-3), 0.0, 1.0)
    extra = 1.0 - ramp
    inv_freq = inv_freq / y["factor"] * (1.0 - extra) + inv_freq * extra
    mscale = yarn_get_mscale(y["factor"], y["mscale"]) / yarn_get_mscale(y["factor"], y["mscale_all_dim"])
    return inv_freq.astype(np.float32), mscale


def n_dense_layers(args: ModelArgs) -> int:
    """Layers before the first MoE layer (every layer without experts)."""
    return min(args.first_k_dense_replace, args.n_layers) if args.n_experts else args.n_layers


def pick_group(K: int, bits: int) -> Optional[int]:
    """The group size of a plain [K, N] projection, or None where it stays
    bf16 (a copy of the reference's MLADecoderModel._pick_group): the
    largest of 128, 64, 32, 16, 8 whose scale rows the reference's stacked
    stream can tile and whose K has a usable k-block (a multiple of 128 and
    of the scale-row chunk that divides K, with a weight tile of at most 4
    MB at the 1024-wide tile). DeepSeek-V2-Lite: K=2048 -> 128, the shared
    experts' K=2816 -> 32, the dense down's K=10944 -> None."""
    pack = 2 if bits == 4 else 1
    for G in (128, 64, 32, 16, 8):
        if K % G:
            continue
        rows = K // G
        if rows % 16 == 0:
            chunk = 16 * G
        elif rows % 8 == 0 and K % (8 * G) == 0:
            chunk = 8 * G
        else:
            continue
        step = math.lcm(chunk, 128)
        bk = (K // step) * step
        while bk >= step:
            if K % bk == 0 and (bk // pack) * 1024 <= 4 * 1024 * 1024:
                return G
            bk -= step
    return None


def expert_group(hidden: int, moe_width: int, group_size: int) -> int:
    """The int4 experts' group size: the requested one (128 by default),
    halved while it does not divide both widths (the reference's rule)."""
    G = group_size or 128
    while G > 8 and (hidden % G or moe_width % G):
        G //= 2
    if hidden % G or moe_width % G:
        raise ValueError(f"no int4 expert group size divides {hidden} and {moe_width}")
    return G


class SharedExperts(nn.Module):
    def __init__(self, d: int, f: int, proj):
        super().__init__()
        self.gate_up_proj = proj(d, 2 * f, parts=2)
        self.down_proj = proj(f, d)


class MLALayer(nn.Module):
    """Attention weights of every layer, then a dense FFN or an MoE block.
    bits (4 or 8) quantizes the experts and, where pick_group allows, the
    projections (see the module docstring); 0 keeps everything dense."""

    def __init__(self, args: ModelArgs, moe: bool, dtype, device, bits: int = 0):
        super().__init__()
        a = args
        D, H = a.hidden_size, a.n_heads
        qk = a.qk_nope_head_dim + a.qk_rope_head_dim
        R, r = a.kv_lora_rank, a.qk_rope_head_dim

        def p(*shape):
            return _param(*shape, dtype=dtype, device=device)

        def proj(k: int, n: int, parts: int = 1, allow: bool = True):
            """A [k -> n] projection (`parts` fused ones): quantized where
            bits are set and pick_group finds a group, else dense."""
            G = pick_group(k, bits) if bits and allow else None
            if G is None:
                return p(n, k)
            return QuantLinear(k, n, bits=bits, group_size=G, scales_dtype=torch.bfloat16,
                               symmetric=True, tile_n=min(DEFAULT_TILE_N, n // parts), device=device)

        self.moe = moe
        self.input_norm = p(D)
        self.post_norm = p(D)
        if a.q_lora_rank:
            self.q_a_proj = p(a.q_lora_rank, D)
            self.q_a_norm = p(a.q_lora_rank)
            self.q_b_proj = proj(a.q_lora_rank, H * qk)
        else:
            self.q_proj = proj(D, H * qk)
        # kv_a only where its width is a multiple of 128, as in the reference.
        self.kv_a_proj = proj(D, R + r, allow=(R + r) % 128 == 0)
        self.kv_a_norm = p(R)
        self.kv_b_proj = p(H * (a.qk_nope_head_dim + a.v_head_dim), R)
        self.o_proj = proj(H * a.v_head_dim, D)
        if moe:
            E, Fm = a.n_experts, a.moe_intermediate_size
            self.router = p(E, D)
            if bits:
                G = expert_group(D, Fm, a.quant_args.group_size) if bits == 4 else 0
                self.experts_gate = QuantExperts(E, D, Fm, bits=bits, group_size=G, device=device)
                self.experts_up = QuantExperts(E, D, Fm, bits=bits, group_size=G, device=device)
                self.experts_down = QuantExperts(E, Fm, D, bits=bits, group_size=G, device=device)
            else:
                self.experts_gate = p(E, Fm, D)
                self.experts_up = p(E, Fm, D)
                self.experts_down = p(E, D, Fm)
            if a.n_shared_experts:
                self.shared_experts = SharedExperts(D, Fm * a.n_shared_experts, proj)
        else:
            self.gate_up_proj = proj(D, 2 * a.intermediate_size, parts=2)
            self.down_proj = proj(a.intermediate_size, D)


class MLADecoderModel(nn.Module):
    """DeepSeek-V2 causal LM."""

    # Its decode-only steps take another attention kernel (K9), so the
    # executor keeps a decode-only step program apart from the mixed one.
    mla = True

    def __init__(self, args: ModelArgs, attn_impl=None, device="cpu", parallel=None, mesh=None):
        super().__init__()
        if parallel is not None and parallel.tp_size > 1:
            raise NotImplementedError("deepseek_v2: not ported: tensor and expert parallelism (tp_size > 1) of the "
                                      "MLA model; serve it with tp_size=1")
        quant = active_quant(args)
        if quant is not None and quant.quant_method != "internal":
            raise NotImplementedError(
                f"deepseek_v2: {quant.quant_method} checkpoints are not supported (nor by the reference); "
                "serve the bf16 checkpoint with quantize='int4' or 'int8'")
        self.args = args
        self.attn_impl = attn_impl or mla_paged_attention
        self.gmm_impl = grouped_matmul
        self.quant_impl = quant_matmul
        self.qexperts_impl = quant_expert_ffn
        # The reference's moe_quant (and proj_quant, the same on one device).
        self.quant_bits = (quant.bits or 8) if quant is not None and args.n_experts > 0 else 0
        if self.quant_bits not in (0, 4, 8):
            raise ValueError(f"quantization to {self.quant_bits} bits is not supported")
        self.dtype = model_dtype(args)
        self.kv_quant = args.kv_cache_dtype == "int8"
        a = args
        self.qk_head_dim = a.qk_nope_head_dim + a.qk_rope_head_dim
        self.latent_dim = a.kv_lora_rank + a.qk_rope_head_dim
        self.n_dense = n_dense_layers(a)
        inv_freq, self.rope_mscale = rope_inv_freq(a)
        self.register_buffer("rope_inv_freq", inv_freq_buffer(inv_freq, device), persistent=False)
        self.sm_scale = self.qk_head_dim ** -0.5
        y = parse_yarn(a)
        if y is not None:
            m = yarn_get_mscale(y["factor"], y["mscale_all_dim"])
            self.sm_scale = self.sm_scale * m * m
        self.embed_tokens = _param(a.vocab_size, a.hidden_size, dtype=self.dtype, device=device)
        self.layers = nn.ModuleList(
            MLALayer(a, moe=i >= self.n_dense, dtype=self.dtype, device=device, bits=self.quant_bits)
            for i in range(a.n_layers)
        )
        self.final_norm = _param(a.hidden_size, dtype=self.dtype, device=device)
        if not a.tie_word_embeddings:
            G = pick_group(a.hidden_size, self.quant_bits) if self.quant_bits else None
            if G:  # the reference quantizes it whenever it quantizes projections
                self.lm_head = QuantLinear(
                    a.hidden_size, a.vocab_size, bits=self.quant_bits, group_size=G,
                    scales_dtype=torch.bfloat16, symmetric=True, device=device)
            else:
                self.lm_head = _param(a.vocab_size, a.hidden_size, dtype=self.dtype, device=device)

    def kv_cache_shape(self, num_pages: int, page_size: int):
        """[L, P, page, 1, kv_lora_rank + rope dims]: one K-only latent head."""
        return (self.args.n_layers, num_pages, page_size, 1, self.latent_dim)

    def kv_cache_dtype(self) -> torch.dtype:
        """The latent pages' type: int8 with kv_quant, else the model's dtype."""
        return torch.int8 if self.kv_quant else self.dtype

    # ------------------------------------------------------------ forward

    def _rope_tables(self, positions: torch.Tensor):
        cos, sin = cos_sin(self.rope_inv_freq, positions)
        return cos * self.rope_mscale, sin * self.rope_mscale

    def _attention(self, layer: MLALayer, h, mi: ModelInputs, cos, sin, kvc, decode_only):
        a = self.args
        H, nope, vd, R = a.n_heads, a.qk_nope_head_dim, a.v_head_dim, a.kv_lora_rank
        T = h.shape[0]
        eps = a.rms_norm_eps
        x = rms_norm(h, layer.input_norm, eps)
        if a.q_lora_rank:
            q = self._proj(rms_norm(F.linear(x, layer.q_a_proj), layer.q_a_norm, eps), layer.q_b_proj)
        else:
            q = self._proj(x, layer.q_proj)
        q = q.view(T, H, self.qk_head_dim)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        ckv = self._proj(x, layer.kv_a_proj)
        c_kv = rms_norm(ckv[:, :R], layer.kv_a_norm, eps)
        q_pe = apply_rope(q_pe, cos, sin, interleaved=True)
        k_pe = apply_rope(ckv[:, None, R:], cos, sin, interleaved=True)[:, 0]

        # kv_b [H * (nope + vd), R] split into the absorb matrices per head.
        w_kv = layer.kv_b_proj.view(H, nope + vd, R)
        q_abs = torch.bmm(q_nope.transpose(0, 1), w_kv[:, :nope])  # [H, T, R]
        q_cat = torch.cat([q_abs.transpose(0, 1), q_pe], dim=-1)  # [T, H, R + r]
        kv_scale = a.kv_scale if self.kv_quant else None
        set_latent_cache(kvc, torch.cat([c_kv, k_pe], dim=-1), mi.new_kv_slot_ids, scale=kv_scale)
        o_lat = self.attn_impl(
            q_cat, kvc, mi.kv_lens, mi.block_tables, mi.cu_q_lens, mi.num_seqs,
            sm_scale=self.sm_scale, v_dim=R, decode_only=decode_only,
            **({"k_scale": kv_scale} if self.kv_quant else {}),
        )  # [T, H, R]
        o = torch.bmm(o_lat.transpose(0, 1), w_kv[:, nope:].transpose(1, 2))  # [H, T, vd]
        return h + self._proj(o.transpose(0, 1).reshape(T, H * vd), layer.o_proj)

    def _proj(self, x: torch.Tensor, w, f32: bool = False) -> torch.Tensor:
        """x @ W^T in x's type, for a dense or a quantized projection; with
        f32 the reference's f32 result (DecoderModel._proj)."""
        if isinstance(w, QuantLinear):
            out = self.quant_impl(x, w.qweight, w.scales, None, bits=w.bits, symmetric=True,
                                  tile_n=w.tile_n)
            return out.float() if f32 else out
        return dense_f32(x, w) if f32 else F.linear(x, w)

    def _router(self, x: torch.Tensor, router_w: torch.Tensor):
        """Softmax scores, greedy or group-limited top-k; then top-k
        renormalisation (norm_topk_prob) or routed_scaling_factor."""
        a = self.args
        scores = torch.softmax(x.float() @ router_w.float().T, dim=-1)
        if a.topk_method == "group_limited_greedy":
            T, E = scores.shape
            group_scores = scores.view(T, a.n_group, E // a.n_group).amax(dim=-1)
            group_idx = torch.topk(group_scores, a.topk_group, dim=-1).indices
            group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1.0)
            mask = group_mask.repeat_interleave(E // a.n_group, dim=-1)
            scores = torch.where(mask > 0, scores, 0.0)
        topk_w, topk_e = torch.topk(scores, a.n_experts_per_token, dim=-1)
        if a.norm_topk_prob and a.n_experts_per_token > 1:
            topk_w = topk_w / (topk_w.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            topk_w = topk_w * a.routed_scaling_factor
        return topk_w, topk_e

    def _moe_ffn(self, layer: MLALayer, x: torch.Tensor) -> torch.Tensor:
        """Routed experts (layers/moe.py:routed_experts) plus the shared
        experts; f32 [T, D]."""
        k = self.args.n_experts_per_token
        topk_w, topk_e = self._router(x, layer.router)
        out = routed_experts(x, topk_w, topk_e, layer.experts_gate, layer.experts_up, layer.experts_down,
                             "silu", gmm=self.gmm_impl, qexperts=self.qexperts_impl,
                             t1_fits=lambda: self._single_token_fits(layer, k))
        if hasattr(layer, "shared_experts"):
            out = out + self._dense_ffn(layer.shared_experts, x, f32=True)
        return out

    @staticmethod
    def _single_token_fits(layer: MLALayer, k: int) -> bool:
        """Whether the T=1 layout applies (layers/moe.py:single_token_fits)."""
        return single_token_fits(k, layer.post_norm.shape[0], layer.experts_gate, layer.experts_down)

    def _dense_ffn(self, mod, x: torch.Tensor, f32: bool = False) -> torch.Tensor:
        """The gated FFN in x's type (f32 with f32); gate and up stay f32
        through the activation, as the reference's."""
        g, u = self._proj(x, mod.gate_up_proj, f32=True).chunk(2, dim=-1)
        m = act_with_mul(self.args.hidden_act, g, u).to(x.dtype)
        return self._proj(m, mod.down_proj, f32=f32)

    def forward(
        self,
        kv_cache: torch.Tensor,  # [L, P, page, 1, Dc], updated in place
        mi: ModelInputs,
        all_hidden: bool = False,
        decode_only: bool = False,  # every sequence slot has one token: K9
    ) -> torch.Tensor:
        a = self.args
        h = self.embed_tokens[mi.token_ids]
        cos, sin = self._rope_tables(mi.positions)
        for layer, kvc in zip(self.layers, kv_cache):
            h = self._attention(layer, h, mi, cos, sin, kvc, decode_only)
            x = rms_norm(h, layer.post_norm, a.rms_norm_eps)
            m = self._moe_ffn(layer, x) if layer.moe else self._dense_ffn(layer, x)
            h = h + m.to(h.dtype)
        h = rms_norm(h, self.final_norm, a.rms_norm_eps)
        return h if all_hidden else h[mi.selected_idxes]

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[S, D] -> [S, V] float32 logits."""
        w = self.embed_tokens if self.args.tie_word_embeddings else self.lm_head
        return self._proj(hidden, w, f32=True)


# ------------------------------------------------------------------ registry


@ModelRegistry.register_model_args("deepseek_v2")
def load_deepseek_v2_model_args(cfg: Dict[str, Any]) -> ModelArgs:
    return ModelArgs(
        model_type="deepseek_v2",
        dtype=hf_dtype(cfg, "bfloat16"),
        hidden_size=cfg.get("hidden_size", 5120),
        hidden_act=cfg.get("hidden_act", "silu"),
        intermediate_size=cfg.get("intermediate_size", 12288),
        n_layers=cfg.get("num_hidden_layers", 60),
        n_heads=cfg.get("num_attention_heads", 128),
        n_kv_heads=cfg.get("num_attention_heads", 128),
        vocab_size=cfg.get("vocab_size", 102400),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        bos_token_id=cfg.get("bos_token_id", 1),
        eos_token_id=cfg.get("eos_token_id", 2),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        norm_type="rms_norm",
        q_lora_rank=cfg.get("q_lora_rank"),
        kv_lora_rank=cfg.get("kv_lora_rank", 512),
        qk_nope_head_dim=cfg.get("qk_nope_head_dim", 128),
        qk_rope_head_dim=cfg.get("qk_rope_head_dim", 64),
        v_head_dim=cfg.get("v_head_dim", 128),
        first_k_dense_replace=cfg.get("first_k_dense_replace", 0),
        n_experts=cfg.get("n_routed_experts") or 0,
        n_experts_per_token=cfg.get("num_experts_per_tok") or 0,
        moe_intermediate_size=cfg.get("moe_intermediate_size", 1407),
        n_shared_experts=cfg.get("n_shared_experts") or 0,
        norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
        routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
        topk_method=cfg.get("topk_method", "greedy"),
        n_group=cfg.get("n_group") or 0,
        topk_group=cfg.get("topk_group") or 0,
        raw=cfg,
    )


def deepseek_weight_rules(q_lora_rank: Optional[int]) -> List[tuple]:
    """HF checkpoint name -> state_dict name ({} the layer, then the expert).
    A dense layer has mlp.{gate,up,down}_proj, an MoE layer mlp.gate,
    mlp.experts.N.* and mlp.shared_experts.*, so the names alone route each
    tensor to its stack. The loader fuses gate/up and stacks the experts."""
    A = r"model\.layers\.(\d+)\."
    rules = [
        (r"model\.embed_tokens\.weight", "embed_tokens"),
        (r"model\.norm\.weight", "final_norm"),
        (r"lm_head\.weight", "lm_head"),
        (A + r"input_layernorm\.weight", "layers.{}.input_norm"),
        (A + r"post_attention_layernorm\.weight", "layers.{}.post_norm"),
        (A + r"self_attn\.kv_a_proj_with_mqa\.weight", "layers.{}.kv_a_proj"),
        (A + r"self_attn\.kv_a_layernorm\.weight", "layers.{}.kv_a_norm"),
        (A + r"self_attn\.kv_b_proj\.weight", "layers.{}.kv_b_proj"),
        (A + r"self_attn\.o_proj\.weight", "layers.{}.o_proj"),
        (A + r"mlp\.gate_proj\.weight", "layers.{}.gate_proj"),
        (A + r"mlp\.up_proj\.weight", "layers.{}.up_proj"),
        (A + r"mlp\.down_proj\.weight", "layers.{}.down_proj"),
        (A + r"mlp\.gate\.weight", "layers.{}.router"),
        (A + r"mlp\.experts\.(\d+)\.gate_proj\.weight", "layers.{}.experts_gate.{}"),
        (A + r"mlp\.experts\.(\d+)\.up_proj\.weight", "layers.{}.experts_up.{}"),
        (A + r"mlp\.experts\.(\d+)\.down_proj\.weight", "layers.{}.experts_down.{}"),
        (A + r"mlp\.shared_experts\.gate_proj\.weight", "layers.{}.shared_experts.gate_proj"),
        (A + r"mlp\.shared_experts\.up_proj\.weight", "layers.{}.shared_experts.up_proj"),
        (A + r"mlp\.shared_experts\.down_proj\.weight", "layers.{}.shared_experts.down_proj"),
    ]
    if q_lora_rank:
        rules += [
            (A + r"self_attn\.q_a_proj\.weight", "layers.{}.q_a_proj"),
            (A + r"self_attn\.q_a_layernorm\.weight", "layers.{}.q_a_norm"),
            (A + r"self_attn\.q_b_proj\.weight", "layers.{}.q_b_proj"),
        ]
    else:
        rules.append((A + r"self_attn\.q_proj\.weight", "layers.{}.q_proj"))
    return rules


@ModelRegistry.register_causal_lm("deepseek_v2")
def create_deepseek_v2(args: ModelArgs, attn_impl=None, device="cpu", **parallel) -> MLADecoderModel:
    model = MLADecoderModel(args, attn_impl, device=device, **parallel)
    model.hf_weight_rules = deepseek_weight_rules(args.q_lora_rank)
    return model


def convert_params(jax_params: Dict, args: ModelArgs) -> Dict[str, torch.Tensor]:
    """The reference package's numpy tree for its MLADecoderModel
    (dense_layers.* and moe_layers.* stacked over their layers, experts
    over E, projections [in, out]) -> this model's state_dict, on the CPU.

    A runtime-quantized tree carries the quantized projections as triples
    in the reference's N-tiled storage [n_n, R, W] per layer: each is
    untiled, cut back to the projection's width, qweight goes to the kernel
    layout [N, R] and the all-zero zeros of the symmetric grid are dropped.
    Quantized experts {qweight [E, K/2 or K, N], scales} go to [E, N, K/2 or
    K] (transposed per expert); their scales keep their type and layout."""

    def tensor(x) -> torch.Tensor:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(arr.copy())

    def proj(x) -> torch.Tensor:  # [in, out] -> [out, in]
        return tensor(x).T.contiguous()

    def experts(x) -> torch.Tensor:  # [E, in, out] -> [E, out, in]
        return tensor(x).transpose(1, 2).contiguous()

    def quant(node, n: int) -> Dict[str, torch.Tensor]:  # one projection's tiled triple
        out = {}
        for key in ("qweight", "scales"):
            t = tensor(node[key])
            t = (untile_quant_layout(t) if t.dim() > 2 else t)[..., :n]
            out[key] = t.T.contiguous() if key == "qweight" else t.contiguous()
        return out

    def put(name: str, node, n: int) -> None:
        if isinstance(node, dict):
            for key, t in quant(node, n).items():
                sd[f"{name}.{key}"] = t
        else:
            sd[name] = proj(node)

    def put_fused(name: str, gate, up, n: int) -> None:
        if isinstance(gate, dict):
            g, u = quant(gate, n), quant(up, n)
            sd[name + ".qweight"] = torch.cat([g["qweight"], u["qweight"]])
            sd[name + ".scales"] = torch.cat([g["scales"], u["scales"]], dim=1)
        else:
            sd[name] = torch.cat([proj(gate), proj(up)])

    a = args
    D, H = a.hidden_size, a.n_heads
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    Fs = a.moe_intermediate_size * a.n_shared_experts
    widths = {"q_proj": ("q_proj", H * qk), "q_b": ("q_b_proj", H * qk),
              "kv_a": ("kv_a_proj", a.kv_lora_rank + a.qk_rope_head_dim),
              "o_proj": ("o_proj", D), "down_proj": ("down_proj", D),
              "shared_down_proj": ("shared_experts.down_proj", D)}
    renames = {"q_a": "q_a_proj", "kv_b": "kv_b_proj", "router": "router"}
    sd = {
        "embed_tokens": tensor(jax_params["embed_tokens"]),
        "final_norm": tensor(jax_params["final_norm"]),
    }
    if not a.tie_word_embeddings:
        put("lm_head", jax_params["lm_head"], a.vocab_size)

    def at(node, i):
        if isinstance(node, dict):
            return {k: np.asarray(v)[i] for k, v in node.items()}
        return np.asarray(node)[i]

    n_dense = n_dense_layers(a)
    for l in range(a.n_layers):
        stack, i = ("dense_layers", l) if l < n_dense else ("moe_layers", l - n_dense)
        layer = {k: at(v, i) for k, v in jax_params[stack].items()}
        pre = f"layers.{l}."
        for name, arr in layer.items():
            if name.endswith("norm"):
                sd[pre + name] = tensor(arr)
            elif name in renames:
                sd[pre + renames[name]] = proj(arr)
            elif name in widths:
                put(pre + widths[name][0], arr, widths[name][1])
            elif name.startswith("moe_") and isinstance(arr, dict):
                sd[pre + "experts_" + name[4:] + ".qweight"] = experts(arr["qweight"])
                sd[pre + "experts_" + name[4:] + ".scales"] = tensor(arr["scales"])
            elif name.startswith("moe_"):
                sd[pre + "experts_" + name[4:]] = experts(arr)
        if "gate_proj" in layer:
            put_fused(pre + "gate_up_proj", layer["gate_proj"], layer["up_proj"], a.intermediate_size)
        if "shared_gate_proj" in layer:
            put_fused(pre + "shared_experts.gate_up_proj", layer["shared_gate_proj"],
                      layer["shared_up_proj"], Fs)
    return sd
