"""DeepSeek-V2 family: Multi-head Latent Attention over a K-only latent page
cache, a dense first stack, then MoE layers with shared experts
(counterpart of scalellm_tpu/models/deepseek.py, the bf16 path).

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
renormalisation; the routed experts through layers/moe.py's sorted dispatch
and grouped GEMMs (K6, three launches a layer); the shared experts as one
plain gated FFN added without a gate.

Weights are nn.Parameters in torch's [out, in] layout, per layer: the dense
FFN's and the shared experts' gate/up fused into gate_up_proj, the routed
experts stacked [E, N, K] (experts_gate, experts_up, experts_down). The
attention and grouped-matmul implementations are hooks (attn_impl, gmm_impl)
so a caller can swap the kernels for their plain versions.

Not ported (each raises NotImplementedError where the model args ask for
it): quantized experts and projections (moe_quant, proj_quant), int8 latent
pages, tensor and expert parallelism. The reference's T=1 sort-free
dispatch belongs to the quantized experts and waits with them.
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
from scalellm_tpu_torch.layers.moe import combine, dispatch, expert_ffn
from scalellm_tpu_torch.layers.norms import rms_norm
from scalellm_tpu_torch.layers.rope import apply_rope
from scalellm_tpu_torch.models.common import _param, active_quant, model_dtype
from scalellm_tpu_torch.models.registry import ModelRegistry
from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul
from scalellm_tpu_torch.ops.mla_attention import mla_paged_attention, set_latent_cache


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


class SharedExperts(nn.Module):
    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.gate_up_proj = _param(2 * f, d, dtype=dtype, device=device)
        self.down_proj = _param(d, f, dtype=dtype, device=device)


class MLALayer(nn.Module):
    """Attention weights of every layer, then a dense FFN or an MoE block."""

    def __init__(self, args: ModelArgs, moe: bool, dtype, device):
        super().__init__()
        a = args
        D, H = a.hidden_size, a.n_heads
        qk = a.qk_nope_head_dim + a.qk_rope_head_dim
        R, r = a.kv_lora_rank, a.qk_rope_head_dim

        def p(*shape):
            return _param(*shape, dtype=dtype, device=device)

        self.moe = moe
        self.input_norm = p(D)
        self.post_norm = p(D)
        if a.q_lora_rank:
            self.q_a_proj = p(a.q_lora_rank, D)
            self.q_a_norm = p(a.q_lora_rank)
            self.q_b_proj = p(H * qk, a.q_lora_rank)
        else:
            self.q_proj = p(H * qk, D)
        self.kv_a_proj = p(R + r, D)
        self.kv_a_norm = p(R)
        self.kv_b_proj = p(H * (a.qk_nope_head_dim + a.v_head_dim), R)
        self.o_proj = p(D, H * a.v_head_dim)
        if moe:
            E, Fm = a.n_experts, a.moe_intermediate_size
            self.router = p(E, D)
            self.experts_gate = p(E, Fm, D)
            self.experts_up = p(E, Fm, D)
            self.experts_down = p(E, D, Fm)
            if a.n_shared_experts:
                self.shared_experts = SharedExperts(D, Fm * a.n_shared_experts, dtype, device)
        else:
            self.gate_up_proj = p(2 * a.intermediate_size, D)
            self.down_proj = p(D, a.intermediate_size)


class MLADecoderModel(nn.Module):
    """DeepSeek-V2 causal LM."""

    def __init__(self, args: ModelArgs, attn_impl=None, device="cpu"):
        super().__init__()
        if active_quant(args) is not None:
            raise NotImplementedError(
                "deepseek_v2: quantized experts and projections (moe_quant, proj_quant) are not ported")
        if args.kv_cache_dtype != "auto":
            raise NotImplementedError("deepseek_v2: int8 latent pages are not ported")
        self.args = args
        self.attn_impl = attn_impl or mla_paged_attention
        self.gmm_impl = grouped_matmul
        self.dtype = model_dtype(args)
        a = args
        self.qk_head_dim = a.qk_nope_head_dim + a.qk_rope_head_dim
        self.latent_dim = a.kv_lora_rank + a.qk_rope_head_dim
        self.n_dense = n_dense_layers(a)
        self.inv_freq, self.rope_mscale = rope_inv_freq(a)
        self.sm_scale = self.qk_head_dim ** -0.5
        y = parse_yarn(a)
        if y is not None:
            m = yarn_get_mscale(y["factor"], y["mscale_all_dim"])
            self.sm_scale = self.sm_scale * m * m
        self.embed_tokens = _param(a.vocab_size, a.hidden_size, dtype=self.dtype, device=device)
        self.layers = nn.ModuleList(
            MLALayer(a, moe=i >= self.n_dense, dtype=self.dtype, device=device)
            for i in range(a.n_layers)
        )
        self.final_norm = _param(a.hidden_size, dtype=self.dtype, device=device)
        if not a.tie_word_embeddings:
            self.lm_head = _param(a.vocab_size, a.hidden_size, dtype=self.dtype, device=device)

    def kv_cache_shape(self, num_pages: int, page_size: int):
        """[L, P, page, 1, kv_lora_rank + rope dims]: one K-only latent head."""
        return (self.args.n_layers, num_pages, page_size, 1, self.latent_dim)

    # ------------------------------------------------------------ forward

    def _rope_tables(self, positions: torch.Tensor):
        inv_freq = torch.from_numpy(self.inv_freq).to(positions.device)
        freqs = positions.float()[:, None] * inv_freq[None, :]
        return torch.cos(freqs) * self.rope_mscale, torch.sin(freqs) * self.rope_mscale

    def _attention(self, layer: MLALayer, h, mi: ModelInputs, cos, sin, kvc, decode_only):
        a = self.args
        H, nope, vd, R = a.n_heads, a.qk_nope_head_dim, a.v_head_dim, a.kv_lora_rank
        T = h.shape[0]
        eps = a.rms_norm_eps
        x = rms_norm(h, layer.input_norm, eps)
        if a.q_lora_rank:
            q = F.linear(rms_norm(F.linear(x, layer.q_a_proj), layer.q_a_norm, eps), layer.q_b_proj)
        else:
            q = F.linear(x, layer.q_proj)
        q = q.view(T, H, self.qk_head_dim)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        ckv = F.linear(x, layer.kv_a_proj)
        c_kv = rms_norm(ckv[:, :R], layer.kv_a_norm, eps)
        q_pe = apply_rope(q_pe, cos, sin, interleaved=True)
        k_pe = apply_rope(ckv[:, None, R:], cos, sin, interleaved=True)[:, 0]

        # kv_b [H * (nope + vd), R] split into the absorb matrices per head.
        w_kv = layer.kv_b_proj.view(H, nope + vd, R)
        q_abs = torch.bmm(q_nope.transpose(0, 1), w_kv[:, :nope])  # [H, T, R]
        q_cat = torch.cat([q_abs.transpose(0, 1), q_pe], dim=-1)  # [T, H, R + r]
        set_latent_cache(kvc, torch.cat([c_kv, k_pe], dim=-1), mi.new_kv_slot_ids)
        o_lat = self.attn_impl(
            q_cat, kvc, mi.kv_lens, mi.block_tables, mi.cu_q_lens, mi.num_seqs,
            sm_scale=self.sm_scale, v_dim=R, decode_only=decode_only,
        )  # [T, H, R]
        o = torch.bmm(o_lat.transpose(0, 1), w_kv[:, nope:].transpose(1, 2))  # [H, T, vd]
        return h + F.linear(o.transpose(0, 1).reshape(T, H * vd), layer.o_proj)

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
        """Routed experts (sorted dispatch, three grouped GEMMs) plus the
        shared experts; f32 [T, D]."""
        topk_w, topk_e = self._router(x, layer.router)
        order, token_of, group_sizes = dispatch(topk_e, self.args.n_experts)
        y = expert_ffn(x[token_of], layer.experts_gate, layer.experts_up, layer.experts_down,
                       group_sizes, "silu", self.gmm_impl)
        out = combine(y, topk_w, order, token_of, x.shape[0])
        if hasattr(layer, "shared_experts"):
            out = out + self._dense_ffn(layer.shared_experts, x).float()
        return out

    def _dense_ffn(self, mod, x: torch.Tensor) -> torch.Tensor:
        g, u = F.linear(x, mod.gate_up_proj).chunk(2, dim=-1)
        m = act_with_mul(self.args.hidden_act, g.float(), u.float()).to(x.dtype)
        return F.linear(m, mod.down_proj)

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
        return F.linear(hidden, w).float()


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
def create_deepseek_v2(args: ModelArgs, attn_impl=None, device="cpu") -> MLADecoderModel:
    model = MLADecoderModel(args, attn_impl, device=device)
    model.hf_weight_rules = deepseek_weight_rules(args.q_lora_rank)
    return model


def convert_params(jax_params: Dict, args: ModelArgs) -> Dict[str, torch.Tensor]:
    """The reference package's numpy tree for its MLADecoderModel
    (dense_layers.* and moe_layers.* stacked over their layers, experts
    over E, projections [in, out]) -> this model's state_dict, on the CPU."""

    def tensor(x) -> torch.Tensor:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(arr.copy())

    def proj(x) -> torch.Tensor:  # [in, out] -> [out, in]
        return tensor(x).T.contiguous()

    def experts(x) -> torch.Tensor:  # [E, in, out] -> [E, out, in]
        return tensor(x).transpose(1, 2).contiguous()

    renames = {"q_proj": "q_proj", "q_a": "q_a_proj", "q_b": "q_b_proj", "kv_a": "kv_a_proj",
               "kv_b": "kv_b_proj", "o_proj": "o_proj", "router": "router",
               "down_proj": "down_proj"}
    sd = {
        "embed_tokens": tensor(jax_params["embed_tokens"]),
        "final_norm": tensor(jax_params["final_norm"]),
    }
    if not args.tie_word_embeddings:
        sd["lm_head"] = proj(jax_params["lm_head"])
    n_dense = n_dense_layers(args)
    for l in range(args.n_layers):
        stack, i = ("dense_layers", l) if l < n_dense else ("moe_layers", l - n_dense)
        layer = {k: np.asarray(v)[i] for k, v in jax_params[stack].items()}
        pre = f"layers.{l}."
        for name, arr in layer.items():
            if name.endswith("norm"):
                sd[pre + name] = tensor(arr)
            elif name in renames:
                sd[pre + renames[name]] = proj(arr)
            elif name.startswith("moe_"):
                sd[pre + "experts_" + name[4:]] = experts(arr)
        if "gate_proj" in layer:
            sd[pre + "gate_up_proj"] = torch.cat([proj(layer["gate_proj"]), proj(layer["up_proj"])])
        if "shared_gate_proj" in layer:
            sd[pre + "shared_experts.gate_up_proj"] = torch.cat(
                [proj(layer["shared_gate_proj"]), proj(layer["shared_up_proj"])])
            sd[pre + "shared_experts.down_proj"] = proj(layer["shared_down_proj"])
    return sd
