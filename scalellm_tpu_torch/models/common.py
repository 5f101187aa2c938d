"""Decoder-only transformer: the Llama / Mistral / Qwen / Qwen2 / Qwen3 /
Gemma / Gemma2 / Mixtral / Qwen2-MoE / GPT-2 / Phi / MPT / BLOOM subset of
scalellm_tpu/models/common.py:DecoderModel.

Embedding (scaled by sqrt(hidden) for Gemma; BLOOM's embedding LayerNorm;
GPT-2's learned positions added) -> per layer (the input norm, fused qkv
projection plus the optional qkv bias and MPT's qkv clip, the optional qk
norm (an RMSNorm of each head's q and k over head_dim, before rope), rope
(rope models only; ALiBi models give the attention their per-head slopes),
in-place KV scatter, ragged paged attention, o projection plus the optional
o bias, the optional post-attention norm, the post norm, then a dense FFN
(fused gate/up projection and a gated activation, or an ungated up
projection and its activation, each with optional biases; down projection
and its optional bias) or, with n_experts, an MoE block, then the optional
post-feedforward norm) -> final norm; logits() applies the lm_head, its
optional bias and the optional final soft cap. Norms are RMSNorm or
LayerNorm (with or without biases) by norm_type. Phi's parallel residual:
attention and MLP read the same normed x, and h + o + m in that order.
Gemma's norms are zero-centred ((1 + w) weights), the qk norm never is.
Gemma2's post-block norms (residual_post_layernorm) normalise the o
projection's output and the FFN's output before their residual adds; its
pre-feedforward norm sits in the post_norm slot. Weights are nn.Parameters
in torch's [out, in] layout, with q/k/v fused into qkv_proj (their biases
into qkv_bias) and gate/up into gate_up_proj as in the reference's fused
layout. The rope table (rope_inv_freq) and the ALiBi slopes (alibi_slopes,
f32 [n_heads]) are model buffers, so that captured step graphs read
persistent tensors. The layers run as a Python loop; the attention
implementation is a hook (attn_impl) so a caller can swap the kernel for the
plain version (ops/attention.py:plain_ragged_paged_attention); it is called
with the step's decode_only (and alibi_slopes on an ALiBi model).

A dense projection whose next operation works in f32 (a bias, MPT's clip,
the activation, the lm_head's logits) returns the f32 product of its bf16
operands, as the reference's preferred_element_type=float32 dot does; the
result is rounded to the model dtype where the reference rounds (after the
activation, at the residual add). A projection followed by nothing in f32
rounds once inside F.linear, which is the same.

An MoE layer (the reference's moe_mlp): the router [E, D] picks top-k
experts by an f32 softmax (optionally renormalised over the k, clamped at
1e-20; layers/moe.py:softmax_topk, exposed as the _router hook), and
layers/moe.py:routed_experts runs them: experts_gate / experts_up [E, Fm, D]
and experts_down [E, D, Fm] through the grouped GEMM (K6, the gmm_impl
hook), or, quantized, through quant_expert_ffn (K8 + K7 on decode-sized
steps, the qexperts_impl hook). With moe_shared_intermediate > 0 a shared
expert of that width (gate_up_proj / down_proj) is added in f32, scaled by
sigmoid(x @ shared_gate) in f32 (Qwen2-MoE). The post-attention norm of an
MoE layer is never folded into a prologue; the experts and the shared expert
read the normed x. Which layers are MoE: every one (the reference ignores
Qwen2-MoE's decoder_sparse_step / mlp_only_layers, and so does this model).

Weight-only quantized models (args.quant_args) hold each projection as a
QuantLinear (kernel-layout qweight, scales, zeros, and for GPTQ desc_act the
row permutation) and run it through ops/quant_matmul.py; quant_impl is a
hook like attn_impl. With desc_act the projections stay unfused (each has
its own row order). Where the reference folds the RMSNorm before a fused
quantized projection into the kernel's prologue (a bias-free RMSNorm, no
parallel residual), so does this model: the projection then gets the
un-normed input. The lm_head is quantized at load when
quant_args.quantize_lm_head asks (int8; "int4" on request). Biases stay in
the model dtype.

Runtime-quantized MoE models (quant_method "internal") follow the
reference's expert rule: int4 experts per (expert, G, channel) with G =
group_size or 128 where G divides both the hidden and the expert width, else
int8 experts per (expert, channel) (not DeepSeek's expert_group, which
halves G until it divides). The router and shared_gate stay dense.
GPTQ/AWQ MoE checkpoints are refused: the reference declares dense experts
for them, and its loader finds no dense expert weights in such a checkpoint.

int8 KV cache (kv_cache_dtype="int8", the reference's kv_quant): the pages
hold round(x / s) clamped to [-127, 127] with per-layer scales s (kv_scales
[L, 2], f32: [k_scale, v_scale] a layer, ModelArgs.kv_scale unless a
calibration's kv_scales.json sidecar gives them). The attention kernels take
only static scales, so the dequantization is applied around them as the
reference applies it: q is multiplied by the layer's k_scale (scores are
linear in k) and rounded to q's type, the kernel reads the pages at a scale
of 1.0 (int8 values are exact in bf16), and the output is multiplied by the
layer's v_scale and rounded.

Multi-LoRA (the reference's lora_add; lora/loader.py loads HF PEFT
adapters, set_lora carries them): q/k/v/o/gate/up/down of a dense layer take
a per-token delta x @ A_s @ B_s of the token's adapter slot s
(mi.lora_ids[mi.token_seg]; slot 0, the base, is zeros), computed as the
reference computes it: the f32 rank intermediates of every slot, masked by a
one-hot over the slots, then expanded, so every adapter mix has the same
shapes and one captured graph serves them all. Targets that read the same
input (q/k/v; gate/up) share one shrink product over their A's concatenated
along the rank (LORA_GROUPS). A target's projection keeps its f32 product,
the delta is added in f32 (q/k/v after the qkv bias, before the clip; o
before its bias), and the result is rounded where the reference rounds.
With adapters no RMSNorm folds into a quantized prologue (the deltas read
the normed x). TF32 stays off for the delta's products.

Tensor parallelism (parallel=ParallelConfig(tp_size=N), mesh=this rank's
parallel/mesh.py Mesh; the reference's shard_map over its "tp" axis, here one
process a rank): each rank holds its slice of the Megatron layout and the
model calls the collectives of parallel/collectives.py where the reference
calls lax.psum / all_gather / psum_scatter. Local q heads H / tp; local KV
heads Hkv / tp, or, where Hkv < tp, one KV head a rank (rank r holds head
r // (tp / Hkv): the reference's replication). qkv_proj and gate_up_proj are
column-parallel, each rank's slice [q_r | k_r | v_r] and [gate_r | up_r];
o_proj and down_proj row-parallel, their f32 partials summed by an
all_reduce, and a row-parallel bias added once, after it. The embedding is
vocab-parallel when the vocabulary divides by tp (ids outside the rank's
rows give zeros, one all_reduce assembles the rows), else replicated; the
lm_head is column-parallel the same way and its logits are gathered. ALiBi
slopes are sliced per rank. MoE layers: experts sharded over the ranks where
tp divides n_experts (each rank runs the (token, slot) pairs of its E / tp
experts; the others' go to an ignored overflow group, the reference's
replicated dispatch), else each expert's FFN width is sharded; the routed
output plus the gated shared expert is all_reduced once. Megatron sequence
parallelism (parallel.sp) behind the reference's gate (dense, no LoRA, T
divisible by tp): the residual stream, norms and embedding hold T / tp
tokens, an all_gather precedes each column-parallel projection and a
reduce_scatter follows each row-parallel one; the final hidden states are
gathered back to T. shard_weight / shard_expert give the loader each
rank's slice of a checkpoint tensor. Not with tp > 1: GPTQ desc_act (the
reference asserts) and LoRA adapters (a ValueError, as the reference's).

Features of the reference's DecoderModel that this subset does not carry
(MLA on this class) raise NotImplementedError when the model args ask for
them.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scalellm_tpu_torch.config import ModelArgs
from scalellm_tpu_torch.engine.params import ModelInputs
from scalellm_tpu_torch.layers.activations import ACT2FN, act_with_mul
from scalellm_tpu_torch.layers.alibi import alibi_slopes
from scalellm_tpu_torch.layers.moe import quant_expert_ffn, routed_experts, softmax_topk
from scalellm_tpu_torch.layers.norms import layer_norm, rms_norm
from scalellm_tpu_torch.layers.rope import apply_rope, compute_inv_freq, cos_sin, inv_freq_buffer
from scalellm_tpu_torch.lora.loader import lora_dims
from scalellm_tpu_torch.ops.attention import ragged_paged_attention
from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul
from scalellm_tpu_torch.ops.kv_update import set_kv_cache
from scalellm_tpu_torch.ops.moe_quant import quantize_experts_int4, quantize_experts_int8
from scalellm_tpu_torch.ops.quant_matmul import (
    DEFAULT_TILE_N,
    LM_HEAD_TILE_N,
    quant_matmul,
    quantize_linear,
    untile_quant_layout,
)
from scalellm_tpu_torch.parallel import collectives as C
from scalellm_tpu_torch.parallel.config import ParallelConfig

# Fused weight -> the checkpoint projections concatenated (in order) along
# the output dim.
FUSED_PROJECTIONS = {
    "qkv_proj": ("q_proj", "k_proj", "v_proj"),
    "gate_up_proj": ("gate_proj", "up_proj"),
    "qkv_bias": ("q_bias", "k_bias", "v_bias"),
    "gate_up_bias": ("gate_bias", "up_bias"),
}

# LoRA targets by the input they read (the normed x of attention, attention's
# output, the MLP's normed x, the activation): one shrink product a group,
# over the group's targets' A concatenated along the rank.
LORA_GROUPS = {
    "qkv": ("q_proj", "k_proj", "v_proj"),
    "o": ("o_proj",),
    "mlp": ("gate_proj", "up_proj"),
    "down": ("down_proj",),
}


def model_dtype(args: ModelArgs) -> torch.dtype:
    """Compute dtype: float16 and float32 checkpoints run as bfloat16 unless
    the model dtype is float32 (the reference executor's casting rule)."""
    return {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.bfloat16,
    }[args.dtype]


def dense_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T with an f32 result, w [out, in]: the reference's jnp.dot(x, w,
    preferred_element_type=float32). On the card one product of x's type
    (bf16) accumulated and returned in f32 (torch.mm's out_dtype); the weight
    is never widened. On the CPU (no aten::mm.dtype there) both operands are
    widened, which is exact for bf16: the f32 sums of the same products."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return F.linear(x, w)
    if x.device.type == "cpu":
        return x.float() @ w.float().T
    return torch.mm(x, w.T, out_dtype=torch.float32)


@contextlib.contextmanager
def _full_f32_matmul():
    """Products of f32 operands in full f32 (no TF32) on the card, as the
    reference's f32 einsums of the LoRA delta."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def lora_layer_tensors(stacks: Dict[str, tuple], layer: int) -> Dict[str, torch.Tensor]:
    """One layer's LoRA buffers from the stacked adapters {"lora_<target>":
    (A [L, n_slots, K, r], B [L, n_slots, r, N])} (lora/loader.py, or the
    reference's parameter tree): lora_A_<group> [K, n * n_slots * r] f32,
    the group's n targets' A in LORA_GROUPS order, each [K, (slot, rank)];
    lora_B_<target> [n_slots * r, N] f32."""
    out = {}
    for group, targets in LORA_GROUPS.items():
        shrink = []
        for t in targets:
            if f"lora_{t}" not in stacks:
                continue
            A, B = (torch.as_tensor(x[layer]).float() for x in stacks[f"lora_{t}"])
            S, K, r = A.shape
            shrink.append(A.permute(1, 0, 2).reshape(K, S * r))
            out[f"lora_B_{t}"] = B.reshape(S * r, B.shape[-1]).contiguous()
        if shrink:
            out[f"lora_A_{group}"] = torch.cat(shrink, dim=1).contiguous()
    return out


def _unsupported(args: ModelArgs, tp: int = 1) -> List[str]:
    quant = active_quant(args)
    checks = {
        "MLA": args.kv_lora_rank > 0,
        "GPTQ desc_act with tp_size > 1": tp > 1 and quant is not None and quant.desc_act,
    }
    return [name for name, on in checks.items() if on]


def _param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=False)


def active_quant(args: ModelArgs):
    """The model's QuantArgs when it is quantized, else None."""
    q = args.quant_args
    return q if (q is not None and q.enabled) else None


class QuantLinear(nn.Module):
    """A weight-only quantized [K -> N] projection in the kernel layout of
    ops/quant_matmul.py: qweight int8 [N, K/2] (int8: [N, K]), scales
    [K/G, N], zeros int8 [K/G, N] unless symmetric, perm int32 [K] under GPTQ
    desc_act (the weight's rows are sorted into contiguous groups, and the
    input is gathered by the same permutation)."""

    def __init__(self, k: int, n: int, *, bits: int, group_size: int,
                 scales_dtype: torch.dtype, symmetric: bool, desc_act: bool = False,
                 tile_n: int = DEFAULT_TILE_N, device="cpu"):
        super().__init__()
        self.bits, self.symmetric, self.tile_n = bits, symmetric, tile_n
        self.group_size = group_size if group_size > 0 else k
        groups = k // self.group_size
        pack = 2 if bits == 4 else 1

        def buf(name, *shape, dtype):
            self.register_buffer(name, torch.empty(*shape, dtype=dtype, device=device))

        buf("qweight", n, k // pack, dtype=torch.int8)
        buf("scales", groups, n, dtype=scales_dtype)
        if not symmetric:
            buf("zeros", groups, n, dtype=torch.int8)
        if desc_act:
            buf("perm", k, dtype=torch.int32)

    def quantize(self, weight: torch.Tensor) -> Dict[str, torch.Tensor]:
        """qweight and scales from a dense [out, in] weight (symmetric,
        runtime quantization), on the weight's device."""
        qweight, scales = quantize_linear(weight, self.bits, self.group_size)
        return {"qweight": qweight, "scales": scales}


class QuantExperts(nn.Module):
    """The E experts of one [K -> N] projection, quantized in the layout of
    ops/moe_quant.py: int4 qweight int8 [E, N, K/2] with bf16 scales [E,
    K/G, N], or int8 qweight [E, N, K] with f32 scales [E, N]."""

    def __init__(self, n_experts: int, k: int, n: int, *, bits: int, group_size: int, device="cpu"):
        super().__init__()
        self.bits, self.group_size = bits, group_size
        E = n_experts
        if bits == 4:
            q_shape, s_shape, s_dtype = (E, n, k // 2), (E, k // group_size, n), torch.bfloat16
        else:
            q_shape, s_shape, s_dtype = (E, n, k), (E, n), torch.float32
        self.register_buffer("qweight", torch.empty(*q_shape, dtype=torch.int8, device=device))
        self.register_buffer("scales", torch.empty(*s_shape, dtype=s_dtype, device=device))

    def quantize(self, weight: torch.Tensor) -> Dict[str, torch.Tensor]:
        """qweight and scales from the dense experts [E, N, K]."""
        if self.bits == 4:
            qweight, scales = quantize_experts_int4(weight, self.group_size)
        else:
            qweight, scales = quantize_experts_int8(weight)
        return {"qweight": qweight, "scales": scales}


def expert_quant(args: ModelArgs) -> Tuple[int, int]:
    """(bits, group size) of the routed experts: (0, 0) dense; under
    runtime quantization int4 at G = group_size or 128 where G divides the
    hidden and the expert width, else int8 per (expert, channel) (G 0): the
    reference's rule (scalellm_tpu/models/common.py:145-170)."""
    quant = active_quant(args)
    if quant is None or args.n_experts == 0:
        return 0, 0
    G = quant.group_size or 128
    if quant.bits == 4 and args.hidden_size % G == 0 and args.moe_intermediate_size % G == 0:
        return 4, G
    return 8, 0


@dataclass(frozen=True)
class Shard:
    """One rank's widths under tensor parallelism over tp ranks (tp 1: the
    whole model): q heads, KV heads (one where Hkv < tp), the dense FFN's or
    shared expert's width, the experts held and each one's width."""
    tp: int
    rank: int
    heads: int
    kv_heads: int
    ffn: int
    experts: int
    expert_ffn: int
    experts_sharded: bool
    vocab: int
    vocab_sharded: bool


def shard_of(args: ModelArgs, tp: int = 1, rank: int = 0) -> Shard:
    """The widths rank `rank` of tp holds (the reference's DecoderModel
    setup, scalellm_tpu/models/common.py:60-107); ValueError where a width
    does not split."""
    H, Hkv, E = args.n_heads, args.n_kv_heads, args.n_experts
    F_ = args.moe_shared_intermediate if E > 0 else args.intermediate_size
    bad = [f"{name} {n}" for name, n in (("n_heads", H), ("ffn width", F_)) if n % tp]
    if Hkv % tp and tp % Hkv:
        bad.append(f"n_kv_heads {Hkv}")
    experts_sharded = E > 0 and tp > 1 and E % tp == 0
    if E > 0 and not experts_sharded and args.moe_intermediate_size % tp:
        bad.append(f"moe_intermediate_size {args.moe_intermediate_size}")
    if bad:
        raise ValueError(f"{args.model_type}: tp_size {tp} does not divide {', '.join(bad)}")
    vocab_sharded = tp > 1 and args.vocab_size % tp == 0
    return Shard(tp=tp, rank=rank, heads=H // tp, kv_heads=max(1, Hkv // tp), ffn=F_ // tp,
                 experts=E // tp if experts_sharded else E,
                 expert_ffn=args.moe_intermediate_size // (1 if experts_sharded else tp),
                 experts_sharded=experts_sharded,
                 vocab=args.vocab_size // tp if vocab_sharded else args.vocab_size, vocab_sharded=vocab_sharded)


class DecoderLayer(nn.Module):
    def __init__(self, args: ModelArgs, dtype: torch.dtype, device, shard: Optional[Shard] = None):
        super().__init__()
        shard = shard or shard_of(args)
        D, Dh = args.hidden_size, args.head_dim
        H, Hkv = shard.heads, shard.kv_heads
        quant = active_quant(args)
        self.moe = args.n_experts > 0
        # A dense layer's FFN, or an MoE layer's shared expert (width 0: none).
        F_ = shard.ffn

        def proj(k: int, n: int):
            if quant is None:
                return _param(n, k, dtype=dtype, device=device)
            return QuantLinear(
                k, n, bits=quant.bits, group_size=quant.group_size,
                # Internal quantizers round their scales through bf16; the
                # f16 scales of a checkpoint need f32.
                scales_dtype=torch.bfloat16 if quant.quant_method == "internal" else torch.float32,
                symmetric=bool(quant.is_sym and not quant.zero_point),
                desc_act=quant.desc_act, device=device)

        def vec(name: str, n: int):
            setattr(self, name, _param(n, dtype=dtype, device=device))

        vec("input_norm", D)
        if args.norm_bias:
            vec("input_norm_bias", D)
        if quant is not None and quant.desc_act:
            self.q_proj = proj(D, H * Dh)
            self.k_proj = proj(D, Hkv * Dh)
            self.v_proj = proj(D, Hkv * Dh)
        else:
            self.qkv_proj = proj(D, (H + 2 * Hkv) * Dh)
        if args.qkv_bias and quant is not None and quant.desc_act:
            self.q_bias = _param(H * Dh, dtype=dtype, device=device)
            self.k_bias = _param(Hkv * Dh, dtype=dtype, device=device)
            self.v_bias = _param(Hkv * Dh, dtype=dtype, device=device)
        elif args.qkv_bias:
            self.qkv_bias = _param((H + 2 * Hkv) * Dh, dtype=dtype, device=device)
        if args.use_qk_norm:
            self.q_norm = _param(Dh, dtype=dtype, device=device)
            self.k_norm = _param(Dh, dtype=dtype, device=device)
        self.o_proj = proj(H * Dh, D)
        if args.o_proj_bias:
            vec("o_bias", D)
        if not args.parallel_residual:  # Phi's MLP reads the input norm's x
            vec("post_norm", D)
            if args.norm_bias:
                vec("post_norm_bias", D)
        if args.residual_post_layernorm:
            vec("post_attn_norm", D)
            vec("post_ffw_norm", D)
        if self.moe:
            E, Fm = shard.experts, shard.expert_ffn
            self.router = _param(args.n_experts, D, dtype=dtype, device=device)
            bits, G = expert_quant(args)
            if bits:
                self.experts_gate = QuantExperts(E, D, Fm, bits=bits, group_size=G, device=device)
                self.experts_up = QuantExperts(E, D, Fm, bits=bits, group_size=G, device=device)
                self.experts_down = QuantExperts(E, Fm, D, bits=bits, group_size=G, device=device)
            else:
                self.experts_gate = _param(E, Fm, D, dtype=dtype, device=device)
                self.experts_up = _param(E, Fm, D, dtype=dtype, device=device)
                self.experts_down = _param(E, D, Fm, dtype=dtype, device=device)
            if F_ > 0:
                self.shared_gate = _param(1, D, dtype=dtype, device=device)
        if F_ == 0:
            return
        if not args.mlp_gated:
            self.up_proj = proj(D, F_)
        elif quant is not None and quant.desc_act:
            self.gate_proj = proj(D, F_)
            self.up_proj = proj(D, F_)
        else:
            self.gate_up_proj = proj(D, 2 * F_)
        self.down_proj = proj(F_, D)
        if args.mlp_bias:
            if not args.mlp_gated:
                vec("up_bias", F_)
            elif quant is not None and quant.desc_act:
                vec("gate_bias", F_)
                vec("up_bias", F_)
            else:
                vec("gate_up_bias", 2 * F_)
            vec("down_bias", D)


class DecoderModel(nn.Module):
    """A causal LM: embedding -> decoder layers -> norm -> lm_head."""

    def __init__(self, args: ModelArgs, attn_impl=None, device="cpu", parallel: Optional[ParallelConfig] = None,
                 mesh=None):
        super().__init__()
        self.parallel = parallel or ParallelConfig()
        tp = self.parallel.tp_size
        missing = _unsupported(args, tp)
        if missing:
            raise NotImplementedError(
                f"{args.model_type}: not ported: {', '.join(missing)}"
            )
        if tp > 1 and (mesh is None or mesh.tp_size != tp):
            raise ValueError(f"tp_size {tp} needs the mesh of this rank (parallel/mesh.py) with tp_size {tp}")
        # This rank's mesh (None: one process) and the widths it holds.
        self.mesh = mesh if tp > 1 else None
        self.shard = shard_of(args, tp, mesh.tp_rank if tp > 1 else 0)
        self.args = args
        self.attn_impl = attn_impl or ragged_paged_attention
        self.quant_impl = quant_matmul
        self.gmm_impl = grouped_matmul
        self.qexperts_impl = quant_expert_ffn
        # Multi-LoRA (lora/loader.py): set by set_lora; the step's
        # ModelInputs.lora_ids then selects each sequence's adapter slot.
        self.lora_meta = None
        self.quant = active_quant(args)
        if self.quant is not None and self.quant.bits not in (4, 8):
            raise ValueError(f"quantization to {self.quant.bits} bits is not supported")
        if self.quant is not None and tp > 1 and self.quant.group_size > 0:
            for name, k in (("o_proj", self.shard.heads * args.head_dim), ("down_proj", self.shard.ffn)):
                if k % self.quant.group_size:
                    raise ValueError(f"{args.model_type}: {name}'s K slice {k} under tp_size {tp} is no multiple "
                                     f"of the group size {self.quant.group_size}")
        if self.quant is not None and args.n_experts > 0 and tp > 1 and not self.shard.experts_sharded:
            raise NotImplementedError(
                f"{args.model_type}: quantized experts under tp_size {tp} need tp to divide n_experts "
                f"({args.n_experts}): the reference shards them over the expert dim only")
        if self.quant is not None and args.n_experts > 0 and self.quant.quant_method != "internal":
            raise NotImplementedError(
                f"{args.model_type}: {self.quant.quant_method} MoE checkpoints are not supported (nor by the "
                "reference: its loader finds no dense expert weights in them); serve the bf16 checkpoint "
                "with quantize='int4' or 'int8'")
        self.dtype = model_dtype(args)
        # int8 KV cache: per-layer [k_scale, v_scale], filled by the loader
        # (ModelArgs.kv_scale, or the calibration sidecar).
        self.kv_quant = args.kv_cache_dtype == "int8"
        if self.kv_quant:
            self.register_buffer("kv_scales", torch.full((args.n_layers, 2), args.kv_scale, dtype=torch.float32,
                                                         device=device))
        D, V = args.hidden_size, self.shard.vocab
        self.embed_tokens = _param(V, D, dtype=self.dtype, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(args, self.dtype, device, self.shard) for _ in range(args.n_layers)
        )
        self.final_norm = _param(D, dtype=self.dtype, device=device)
        if args.norm_bias:
            self.final_norm_bias = _param(D, dtype=self.dtype, device=device)
        if args.embedding_norm:  # BLOOM's word_embeddings_layernorm
            self.embed_norm = _param(D, dtype=self.dtype, device=device)
            if args.norm_bias:
                self.embed_norm_bias = _param(D, dtype=self.dtype, device=device)
        if args.pos_embedding_type == "learned":
            self.embed_positions = _param(args.max_position_embeddings, D, dtype=self.dtype, device=device)
        if args.pos_embedding_type == "rope":
            self.register_buffer("rope_inv_freq", inv_freq_buffer(compute_inv_freq(args), device),
                                 persistent=False)
        elif args.pos_embedding_type == "alibi":
            # Built on the CPU for a meta-device model; the loader moves it.
            on = "cpu" if torch.device(device).type == "meta" else device
            H = self.shard.heads  # this rank's heads' slopes
            slopes = alibi_slopes(args.n_heads)[self.shard.rank * H:(self.shard.rank + 1) * H]
            self.register_buffer("alibi_slopes", torch.tensor(slopes, dtype=torch.float32, device=on),
                                 persistent=False)
        elif args.pos_embedding_type not in ("learned", "none"):
            raise ValueError(f"{args.model_type}: unknown pos_embedding_type {args.pos_embedding_type!r}")
        if not args.tie_word_embeddings:
            if self._lm_head_quant():
                self.lm_head = QuantLinear(
                    D, V, bits=self._lm_head_bits(), group_size=128,
                    scales_dtype=torch.bfloat16, symmetric=True,
                    tile_n=LM_HEAD_TILE_N, device=device)
            else:
                self.lm_head = _param(V, D, dtype=self.dtype, device=device)
            if args.lm_head_bias:
                self.lm_head_bias = _param(V, dtype=self.dtype, device=device)

    @property
    def tp_size(self) -> int:
        return self.parallel.tp_size

    @property
    def parallel_kw(self) -> dict:
        """The keyword arguments that build another model of this rank's
        slice (runtime quantization)."""
        return {"parallel": self.parallel, "mesh": self.mesh}

    def _lm_head_quant(self) -> bool:
        return bool(
            self.quant is not None
            and self.quant.quantize_lm_head
            and self.args.hidden_size % 128 == 0
        )

    def _lm_head_bits(self) -> int:
        """quantize_lm_head: truthy -> int8; the string "int4" -> int4."""
        return 4 if self.quant.quantize_lm_head == "int4" else 8

    # ------------------------------------------------------------ shards

    def _cut(self, kind: str) -> slice:
        """This rank's part of a full width of `kind`: "q" the q heads'
        H * Dh, "kv" the KV heads' Hkv * Dh (where Hkv < tp the one head
        r // (tp / Hkv)), "f" the FFN's (or shared expert's) width, "v" the
        vocabulary."""
        sh, Dh = self.shard, self.args.head_dim
        if kind == "kv" and self.args.n_kv_heads < sh.tp:
            head = sh.rank // (sh.tp // self.args.n_kv_heads)
            return slice(head * Dh, (head + 1) * Dh)
        n = {"q": sh.heads * Dh, "kv": sh.kv_heads * Dh, "f": sh.ffn, "v": sh.vocab}[kind]
        return slice(sh.rank * n, (sh.rank + 1) * n)

    def _part_widths(self, kinds) -> List[int]:
        a = self.args
        full = {"q": a.n_heads * a.head_dim, "kv": a.n_kv_heads * a.head_dim,
                "f": self.shard.ffn * self.shard.tp}
        return [full[k] for k in kinds]

    def shard_weight(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full checkpoint tensor `name` (a state
        dict name, or a part the loader fuses: layers.N.q_proj[.qweight]),
        in the model's layout: dense weights [out, in], the kernel layout of
        quantized ones (qweight [N, K/2 or K], scales and zeros [K/G, N]).
        Column-parallel tensors are cut along N, the fused ones part by part
        ([q_r | k_r | v_r], [gate_r | up_r]); row-parallel ones along K (a
        quantized one at a multiple of its group); the embedding, lm_head
        and its bias along the vocabulary where it is sharded; everything
        else is whole. Identity with tp 1."""
        if self.tp_size == 1:
            return t
        prefix, _, leaf = name.rpartition(".")
        quant_leaf = leaf in ("qweight", "scales", "zeros", "g_idx")
        module = prefix.rpartition(".")[2] if quant_leaf else leaf
        if module in ("embed_tokens", "lm_head", "lm_head_bias"):
            if not self.shard.vocab_sharded:
                return t
            dim = 1 if leaf in ("scales", "zeros") else 0
            return t.narrow(dim, self._cut("v").start, self.shard.vocab)
        column = {"q_proj": ("q",), "k_proj": ("kv",), "v_proj": ("kv",), "q_bias": ("q",), "k_bias": ("kv",),
                  "v_bias": ("kv",), "gate_proj": ("f",), "up_proj": ("f",), "gate_bias": ("f",),
                  "up_bias": ("f",), "qkv_proj": ("q", "kv", "kv"), "qkv_bias": ("q", "kv", "kv"),
                  "gate_up_proj": ("f", "f"), "gate_up_bias": ("f", "f")}
        row = {"o_proj": "q", "down_proj": "f"}
        if module in column:
            dim = 1 if leaf in ("scales", "zeros") else 0
            kinds = column[module]
            parts = t.split(self._part_widths(kinds), dim=dim) if len(kinds) > 1 else (t,)
            cuts = [p.narrow(dim, self._cut(k).start, self._cut(k).stop - self._cut(k).start)
                    for p, k in zip(parts, kinds)]
            return cuts[0] if len(cuts) == 1 else torch.cat(cuts, dim=dim)
        if module in row:
            cut = self._cut(row[module])
            if not quant_leaf:
                return t.narrow(t.dim() - 1, cut.start, cut.stop - cut.start)
            if leaf == "g_idx":
                raise NotImplementedError("GPTQ desc_act with tp_size > 1")
            K = self._part_widths(row[module])[0]
            if leaf == "qweight":  # [N, K / pack]
                pack = K // t.shape[1]
                return t.narrow(1, cut.start // pack, (cut.stop - cut.start) // pack)
            G = K // t.shape[0]  # scales / zeros [K / G, N]
            if (cut.stop - cut.start) % G:
                raise ValueError(f"{name}: the rank's K slice {cut.stop - cut.start} is no multiple of the "
                                 f"group size {G}")
            return t.narrow(0, cut.start // G, (cut.stop - cut.start) // G)
        return t

    def shard_expert(self, stack: str, slot: int, t: torch.Tensor) -> Tuple[Optional[int], torch.Tensor]:
        """(this rank's slot, its slice) of expert `slot`'s checkpoint tensor
        of the stacked parameter `stack` (layers.N.experts_{gate,up,down}, a
        dense [N, K] a slot): with the experts sharded, slot - rank * E / tp
        and the tensor whole, or None for another rank's expert; otherwise
        the slot, and the expert's width cut (gate/up along N, down along
        K). Identity with tp 1."""
        sh = self.shard
        if sh.tp == 1:
            return slot, t
        if sh.experts_sharded:
            local = slot - sh.rank * sh.experts
            return (local, t) if 0 <= local < sh.experts else (None, t)
        n = sh.expert_ffn
        dim = 1 if stack.endswith("experts_down") else 0
        return slot, t.narrow(dim, sh.rank * n, n)

    # ------------------------------------------------------------ LoRA

    def set_lora(self, meta, stacks: Optional[Dict[str, tuple]] = None) -> None:
        """Carry the adapters of `meta` (a lora/loader.py LoraMeta): each
        layer gets the buffers of lora_layer_tensors on the model's device,
        from `stacks` (load_lora_adapters' output) or zeros for a state dict
        to fill (convert_params). The base model is slot 0."""
        if self.tp_size > 1:  # the reference's rule (scalellm_tpu/lora/loader.py:112)
            raise ValueError("LoRA adapters require tp_size == 1")
        L, S, r = self.args.n_layers, meta.n_slots, meta.r_max
        device = self.embed_tokens.device
        if stacks is None:
            dims = lora_dims(self.args)
            stacks = {f"lora_{t}": (torch.zeros(L, S, dims[t][0], r), torch.zeros(L, S, r, dims[t][1]))
                      for t in meta.targets}
        for li, layer in enumerate(self.layers):
            # Each target's place among its group's targets in lora_A_<group>.
            layer.lora_cols = {t: j for targets in LORA_GROUPS.values()
                               for j, t in enumerate(t for t in targets if t in meta.targets)}
            for name, t in lora_layer_tensors(stacks, li).items():
                layer.register_buffer(name, t.to(device))
        self.register_buffer("lora_slot_ids", torch.arange(S, dtype=torch.int32, device=device), persistent=False)
        self.lora_meta = meta

    def _lora_mask(self, mi: ModelInputs) -> Optional[torch.Tensor]:
        """[T, n_slots * r_max] f32: ones over the rank columns of each
        token's adapter slot (mi.lora_ids[mi.token_seg]), zeros elsewhere;
        None without adapters."""
        if self.lora_meta is None or mi.lora_ids is None:
            return None
        slot = mi.lora_ids[mi.token_seg]
        onehot = (slot[:, None] == self.lora_slot_ids).float()  # [T, S]
        T, S = onehot.shape
        return onehot[:, :, None].expand(T, S, self.lora_meta.r_max).reshape(T, -1)

    def _lora_shrink(self, layer: DecoderLayer, group: str, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[T, n, n_slots * r] the masked f32 rank intermediates of the
        group's n targets: x @ A of every slot (one product), each token's
        own slot kept."""
        with _full_f32_matmul():
            za = x.float() @ getattr(layer, f"lora_A_{group}")
        return za.view(za.shape[0], -1, mask.shape[1]) * mask[:, None, :]

    def _lora_delta(self, layer: DecoderLayer, target: str, za: torch.Tensor) -> torch.Tensor:
        """[T, N] f32: the target's delta from its group's intermediates."""
        with _full_f32_matmul():
            return za[:, layer.lora_cols[target]] @ getattr(layer, f"lora_B_{target}")

    # ------------------------------------------------------------ kv cache

    def kv_cache_shape(self, num_pages: int, page_size: int):
        """[L, P, page, 2 * Hkv, Dh], K at even and V at odd combined heads;
        Hkv this rank's KV heads."""
        a = self.args
        return (a.n_layers, num_pages, page_size, 2 * self.shard.kv_heads, a.head_dim)

    def kv_cache_dtype(self) -> torch.dtype:
        """The KV pages' type: int8 with kv_quant, else the model's dtype."""
        return torch.int8 if self.kv_quant else self.dtype

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

    def _proj(self, x: torch.Tensor, w, rms: Optional[Tuple[torch.Tensor, float]] = None, f32: bool = False):
        """x @ W^T for a dense or quantized projection, in x's type, or with
        f32 the reference's f32 result: a dense weight's product of x's type
        in f32 (dense_f32), a quantized one's output (x's type) widened.
        rms=(gamma, eps) asks for the RMSNorm of x first; for a quantized
        projection it goes into the matmul's prologue, and the caller passes
        the un-normed input."""
        if isinstance(w, QuantLinear):
            if "perm" in w._buffers:
                x = x[:, w.perm]
            out = self.quant_impl(
                x, w.qweight, w.scales, w._buffers.get("zeros"), bits=w.bits,
                symmetric=w.symmetric, tile_n=w.tile_n,
                rms_gamma=rms[0] if rms is not None else None,
                rms_eps=float(rms[1]) if rms is not None else 1e-6,
            )
            return out.float() if f32 else out
        if rms is not None:
            x = rms_norm(x, rms[0], rms[1])
        return dense_f32(x, w) if f32 else F.linear(x, w)

    def _norm(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The model's norm rule (the reference's _norm): RMSNorm (zero-centred
        for Gemma), or LayerNorm with its optional bias."""
        a = self.args
        if a.norm_type == "rms_norm":
            return rms_norm(x, w, a.rms_norm_eps, a.zero_centered_norm)
        return layer_norm(x, w, b, a.layer_norm_eps)

    def _fused_norm(self, layer: DecoderLayer, proj: str, norm: torch.Tensor):
        """(gamma, eps) when the RMSNorm before `proj` folds into the quant
        matmul's prologue (a fused quantized projection without a row
        permutation; never the post-attention norm of an MoE layer), else
        None: the reference's _can_fuse (an RMSNorm without a bias, no
        parallel residual, no LoRA adapters: their deltas read the normed x).
        A qkv bias does not stop it: it is added to the
        matmul's output. Gemma2's pre-feedforward norm (the
        post_norm slot) folds as 1 + w in f32; the post-block norms follow
        a projection and never fold."""
        a = self.args
        if (layer.moe and proj == "gate_up_proj") or a.norm_type != "rms_norm" or a.norm_bias \
                or a.parallel_residual or self.lora_meta is not None:
            return None
        w = getattr(layer, proj, None)
        if not isinstance(w, QuantLinear) or "perm" in w._buffers:
            return None
        if a.zero_centered_norm:
            norm = 1.0 + norm.float()
        return norm, a.rms_norm_eps

    def forward(
        self,
        kv_cache: torch.Tensor,  # [L, P, page, 2*Hkv, Dh], updated in place
        mi: ModelInputs,
        all_hidden: bool = False,
        decode_only: bool = False,  # every sequence slot has one token; passed to attn_impl
    ) -> torch.Tensor:
        """Returns the final hidden states of the selected rows [S, D] (all
        rows [T, D] with all_hidden). The KV cache is written in place."""
        a = self.args
        H, Hkv, Dh = self.shard.heads, self.shard.kv_heads, a.head_dim
        q_n, kv_n = H * Dh, Hkv * Dh
        sm_scale = self._sm_scale()
        soft_cap = a.attn_logit_soft_cap if a.attn_logit_soft_cap > 0 else None
        T = mi.token_ids.shape[0]
        sp = self._sp(T)
        # Under SP this rank's token rows of the residual stream.
        rows = slice(self.shard.rank * T // self.shard.tp, (self.shard.rank + 1) * T // self.shard.tp) \
            if sp else slice(None)

        h = self._embed(mi.token_ids, rows)  # [T, D] ([T / tp, D] under SP)
        if a.normalize_embedding:
            h = (h.float() * math.sqrt(a.hidden_size)).to(h.dtype)
        if a.embedding_norm:
            h = self._norm(h, self.embed_norm, getattr(self, "embed_norm_bias", None))
        if a.pos_embedding_type == "learned":
            h = h + self.embed_positions[mi.positions[rows]]
        rope = a.pos_embedding_type == "rope"
        if rope:
            cos, sin = cos_sin(self.rope_inv_freq, mi.positions)
        alibi = {"alibi_slopes": self.alibi_slopes} if a.pos_embedding_type == "alibi" else {}
        # int8 pages: the kernel reads them at a scale of 1.0; the layer's
        # scales act on q and o below.
        unit = {"k_scale": 1.0, "v_scale": 1.0} if self.kv_quant else {}
        # LoRA: the targets' products stay f32 until their deltas are added.
        lora = self._lora_mask(mi)
        targets = self.lora_meta.targets if lora is not None else ()
        lora_qkv = [t for t in LORA_GROUPS["qkv"] if t in targets]
        lora_o = "o_proj" in targets
        # The qkv product stays f32 where a bias, the clip or a delta works on it.
        qkv_f32 = a.qkv_bias or a.qkv_clip > 0 or bool(lora_qkv)
        # Row-parallel partials are summed in f32.
        tp = self.tp_size > 1

        for li, (layer, kvc, window) in enumerate(zip(self.layers, kv_cache, self._layer_windows())):
            rms = self._fused_norm(layer, "qkv_proj", layer.input_norm)
            x = h if rms else self._norm(h, layer.input_norm, getattr(layer, "input_norm_bias", None))
            x = self._gather(x, sp)  # SP: the column-parallel qkv reads all T tokens
            if hasattr(layer, "qkv_proj"):
                qkv = self._proj(x, layer.qkv_proj, rms, f32=qkv_f32)
                if a.qkv_bias:
                    qkv = qkv + layer.qkv_bias.float()
                q, k, v = qkv.split([q_n, kv_n, kv_n], dim=-1)
            else:  # desc_act: unfused projections
                q, k, v = (self._proj(x, w, f32=qkv_f32) for w in (layer.q_proj, layer.k_proj, layer.v_proj))
                if a.qkv_bias:
                    q, k, v = (t + b.float() for t, b in zip((q, k, v), (layer.q_bias, layer.k_bias, layer.v_bias)))
            if lora_qkv:
                za = self._lora_shrink(layer, "qkv", x, lora)
                q, k, v = (t + self._lora_delta(layer, name, za) if name in lora_qkv else t
                           for t, name in zip((q, k, v), LORA_GROUPS["qkv"]))
            if a.qkv_clip > 0:  # MPT's clip_qkv, in f32 before the cast
                q, k, v = (t.clamp(-a.qkv_clip, a.qkv_clip) for t in (q, k, v))
            q, k, v = (t.to(h.dtype) for t in (q, k, v))
            q, k = q.reshape(T, H, Dh), k.reshape(T, Hkv, Dh)
            if a.use_qk_norm:
                q = rms_norm(q, layer.q_norm, a.rms_norm_eps)
                k = rms_norm(k, layer.k_norm, a.rms_norm_eps)
            if rope:
                q = apply_rope(q, cos, sin, a.interleaved_rope)
                k = apply_rope(k, cos, sin, a.interleaved_rope)
            ks = vs = None
            if self.kv_quant:
                ks, vs = self.kv_scales[li, 0], self.kv_scales[li, 1]
            set_kv_cache(kvc, k, v.reshape(T, Hkv, Dh), mi.new_kv_slot_ids, k_scale=ks, v_scale=vs)
            if self.kv_quant:
                q = (q.float() * ks).to(q.dtype)
            o = self.attn_impl(
                q.contiguous(), kvc, mi.kv_lens, mi.block_tables, mi.cu_q_lens,
                mi.num_seqs, sm_scale=sm_scale, sliding_window=window,
                logit_soft_cap=soft_cap, decode_only=decode_only, **alibi, **unit,
            )
            if self.kv_quant:
                o = (o.float() * vs).to(o.dtype)
            o_in = o.reshape(T, q_n)
            o = self._proj(o_in, layer.o_proj, f32=a.o_proj_bias or lora_o or tp)
            if lora_o:
                o = o + self._lora_delta(layer, "o_proj", self._lora_shrink(layer, "o", o_in, lora))
            o = self._combine(o, sp)
            if a.o_proj_bias:
                o = o + layer.o_bias.float()
            if a.parallel_residual:  # Phi: the MLP reads the same normed x
                m = self._mlp(layer, x, lora=lora, sp=sp)
                h = h + o.to(h.dtype) + m.to(h.dtype)
                continue
            if a.residual_post_layernorm:
                o = rms_norm(o.to(h.dtype), layer.post_attn_norm, a.rms_norm_eps, a.zero_centered_norm)
            h = h + o.to(h.dtype)

            rms = self._fused_norm(layer, "gate_up_proj", layer.post_norm)
            x = h if rms else self._norm(h, layer.post_norm, getattr(layer, "post_norm_bias", None))
            m = self._mlp(layer, self._gather(x, sp), rms, lora, sp)
            if a.residual_post_layernorm:
                m = rms_norm(m.to(h.dtype), layer.post_ffw_norm, a.rms_norm_eps, a.zero_centered_norm)
            h = h + m.to(h.dtype)

        h = self._gather(self._norm(h, self.final_norm, getattr(self, "final_norm_bias", None)), sp)
        if all_hidden:
            return h
        return h[mi.selected_idxes]

    # ------------------------------------------------------------ parallel

    def _sp(self, T: int) -> bool:
        """Whether this step runs sequence parallel: the reference's static
        gate (scalellm_tpu/models/common.py:786-792): SP asked for, tp > 1,
        a dense model without LoRA, T divisible by tp."""
        a = self.args
        return (self.parallel.sp and self.tp_size > 1 and a.n_experts == 0 and self.lora_meta is None
                and T % self.tp_size == 0)

    def _gather(self, x: torch.Tensor, sp: bool) -> torch.Tensor:
        """SP: the token shard gathered to all T rows (before a
        column-parallel projection); otherwise x."""
        return C.all_gather(x, 0, self.mesh) if sp else x

    def _combine(self, y: torch.Tensor, sp: bool) -> torch.Tensor:
        """A row-parallel projection's partials summed over the ranks: an
        all_reduce of the f32 partials, or under SP a reduce_scatter that
        leaves this rank its token rows. Identity on one rank."""
        if self.mesh is None:
            return y
        return C.reduce_scatter(y.float(), 0, self.mesh) if sp else C.all_reduce(y.float(), self.mesh)

    def _embed(self, token_ids: torch.Tensor, rows: slice) -> torch.Tensor:
        """Embedding rows of token_ids[rows]. Vocab-parallel (the reference's
        VocabParallelEmbedding): each rank looks up the ids inside its rows
        of the table, zeros elsewhere, and an all_reduce of all T ids
        assembles them (one rank is nonzero a row, so the f32 sum is
        exact); the rows are sliced after it."""
        if not self.shard.vocab_sharded:
            return self.embed_tokens[token_ids[rows]]
        v = self.shard.vocab
        local = token_ids.long() - self.shard.rank * v
        inside = (local >= 0) & (local < v)
        found = self.embed_tokens[local.clamp(0, v - 1)].float() * inside[:, None]
        return C.all_reduce(found, self.mesh)[rows].to(self.dtype)

    def _mlp(self, layer: DecoderLayer, x: torch.Tensor, rms=None, lora=None, sp: bool = False) -> torch.Tensor:
        """The layer's FFN: the MoE block (f32), or the dense FFN in x's type
        (f32 with a down_proj LoRA delta, a down bias or tp > 1), with its
        partials combined over the ranks (_combine; the MoE block's by one
        all_reduce) and then its down bias added; lora: the step's _lora_mask
        or None."""
        if layer.moe:
            return C.all_reduce(self._moe(layer, x), self.mesh)
        if not self.args.mlp_bias and self.mesh is None:
            return self._dense_ffn(layer, x, rms, lora=lora)
        m = self._combine(self._dense_ffn(layer, x, rms, f32=True, lora=lora), sp)
        return m + layer.down_bias.float() if self.args.mlp_bias else m

    def _dense_ffn(self, layer: DecoderLayer, x: torch.Tensor, rms=None, f32: bool = False,
                   lora=None) -> torch.Tensor:
        """The FFN (a dense layer's, or an MoE layer's shared expert) without
        its down bias, in x's type or f32; rms as in _proj. The gate and up
        products stay f32, with their biases and LoRA deltas, through the
        activation; with a down_proj delta the output is f32."""
        a = self.args
        targets = self.lora_meta.targets if lora is not None else ()
        za = None
        if any(t in targets for t in LORA_GROUPS["mlp"]):
            za = self._lora_shrink(layer, "mlp", x, lora)

        def delta(y, target):
            return y + self._lora_delta(layer, target, za) if target in targets else y

        if not a.mlp_gated:
            u = self._proj(x, layer.up_proj, f32=True)
            if a.mlp_bias:
                u = u + layer.up_bias.float()
            m = ACT2FN[a.hidden_act](delta(u, "up_proj"))
        else:
            if hasattr(layer, "gate_up_proj"):
                g, u = self._proj(x, layer.gate_up_proj, rms, f32=True).chunk(2, dim=-1)
                if a.mlp_bias:
                    gb, ub = layer.gate_up_bias.float().chunk(2)
                    g, u = g + gb, u + ub
            else:
                g, u = self._proj(x, layer.gate_proj, f32=True), self._proj(x, layer.up_proj, f32=True)
                if a.mlp_bias:
                    g, u = g + layer.gate_bias.float(), u + layer.up_bias.float()
            m = act_with_mul(a.hidden_act, delta(g, "gate_proj"), delta(u, "up_proj"))
        m = m.to(x.dtype)
        if "down_proj" not in targets:
            return self._proj(m, layer.down_proj, f32=f32)
        d = self._proj(m, layer.down_proj, f32=True)
        return d + self._lora_delta(layer, "down_proj", self._lora_shrink(layer, "down", m, lora))

    def _router(self, x: torch.Tensor, router_w: torch.Tensor):
        """Routing weights and experts [T, k] (the reference moe_mlp's: f32
        softmax, top-k, optional renormalisation)."""
        a = self.args
        return softmax_topk(x, router_w, a.n_experts_per_token, a.norm_topk_prob)

    def _moe(self, layer: DecoderLayer, x: torch.Tensor) -> torch.Tensor:
        """The routed experts plus the gated shared expert, f32 [T, D] (this
        rank's part under tp). With the experts sharded, this rank's E / tp
        experts take their pairs and the other pairs go to the overflow
        group E / tp with weight 0 (the reference's ep_axis remap,
        scalellm_tpu/layers/moe.py:270-280); the T=1 layout is not used
        then (it needs the token's k experts held)."""
        topk_w, topk_e = self._router(x, layer.router)
        t1_fits = None
        if self.shard.experts_sharded:
            n = self.shard.experts
            local = topk_e - self.shard.rank * n
            held = (local >= 0) & (local < n)
            topk_e = torch.where(held, local, n)
            topk_w = torch.where(held, topk_w, 0.0)
            t1_fits = _never
        out = routed_experts(x, topk_w, topk_e, layer.experts_gate, layer.experts_up, layer.experts_down,
                             self.args.hidden_act, gmm=self.gmm_impl, qexperts=self.qexperts_impl,
                             t1_fits=t1_fits)
        if hasattr(layer, "shared_gate"):
            gate = torch.sigmoid(x.float() @ layer.shared_gate.float().T)  # [T, 1]
            out = out + self._dense_ffn(layer, x, f32=True) * gate
        return out

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[S, D] -> [S, V] float32 logits (a vocab-parallel lm_head's
        gathered over the ranks, the bias added before the gather)."""
        a = self.args
        w = self.embed_tokens if a.tie_word_embeddings else self.lm_head
        logits = self._proj(hidden, w, f32=True)
        if a.lm_head_bias and not a.tie_word_embeddings:
            logits = logits + self.lm_head_bias.float()
        if self.shard.vocab_sharded:
            logits = C.all_gather(logits, 1, self.mesh)
        if a.final_logit_soft_cap > 0.0:
            cap = a.final_logit_soft_cap
            logits = cap * torch.tanh(logits / cap)
        return logits


def _never() -> bool:
    return False


def shard_state_dict(sd: Dict[str, torch.Tensor], model) -> Dict[str, torch.Tensor]:
    """This rank's state dict from the whole (tp 1) one of the same model:
    every tensor through the rank model's shard_weight, stacked experts [E,
    ...] (dense or quantized) through shard_expert slot by slot. Identity
    for a model of tp 1."""
    if model.tp_size == 1:
        return sd
    out = {}
    for name, t in sd.items():
        prefix, _, leaf = name.rpartition(".")
        stack = prefix if leaf in ("qweight", "scales") else name
        if stack.rpartition(".")[2].startswith("experts_"):
            slots = [model.shard_expert(stack, e, t[e]) for e in range(t.shape[0])]
            out[name] = torch.stack([x for slot, x in slots if slot is not None]).contiguous()
        else:
            out[name] = model.shard_weight(name, t).contiguous()
    return out


def convert_params(jax_params: Dict, args: ModelArgs, model=None) -> Dict[str, torch.Tensor]:
    """The reference package's numpy parameter tree (fused layout, per-layer
    tensors stacked over L, projections [in, out]) -> this model's
    state_dict (per-layer tensors, projections [out, in]), on the CPU.

    A quantized projection arrives as a dict of the reference's N-tiled
    arrays [L, N_pad/W, R, W] (or flat [L, R, N]): each is untiled, cut back
    to the projection's N, and qweight goes to the kernel layout. Scales keep
    their type (bf16 or f32), so their values carry over exactly; zeros are
    dropped for a symmetric model, as its matmuls never read them.

    MoE layers: the router [D, E] and shared_gate [D, 1] are transposed, the
    experts moe_{gate,up,down} [E, K, N] go to [E, N, K] (quantized:
    qweight [E, K/2 or K, N] to [E, N, K/2 or K], scales as they are), the
    shared expert rides the dense FFN's names at its own width; the biases
    (qkv, o, MLP, norms, lm_head), the qk norms, the post-block norms, the
    embedding norm and the learned positions carry over as they are, and so
    do an int8-KV model's per-layer scales (layers.kv_scales [L, 2], this
    model's kv_scales). LoRA adapters (layers.lora_<target>: (A [L, slots,
    K, r], B [L, slots, r, N])) go to each layer's lora_layer_tensors, for a
    model whose set_lora was given the same LoraMeta.

    The per-rank form: with `model`, a DecoderModel of tp > 1, the rank's
    slice of that state dict (shard_state_dict), so that the reference's
    parameters of one device can be fed to each rank."""
    import numpy as np

    if model is not None and model.tp_size > 1:
        return shard_state_dict(convert_params(jax_params, args), model)

    def tensor(x) -> torch.Tensor:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(arr.copy())

    quant = active_quant(args)
    symmetric = quant is not None and bool(quant.is_sym and not quant.zero_point)
    D, Dh = args.hidden_size, args.head_dim
    F_ = args.moe_shared_intermediate if args.n_experts else args.intermediate_size
    q_n, kv_n = args.n_heads * Dh, args.n_kv_heads * Dh
    widths = {
        "qkv_proj": q_n + 2 * kv_n, "q_proj": q_n, "k_proj": kv_n, "v_proj": kv_n,
        "o_proj": D, "gate_up_proj": 2 * F_, "gate_proj": F_, "up_proj": F_,
        "down_proj": D,
    }

    def put_quant(prefix, node, n, drop_zeros):
        for key, arr in node.items():
            t = tensor(arr)
            if key == "perm":
                sd[f"{prefix}.perm"] = t.to(torch.int32)
                continue
            if key == "zeros" and drop_zeros:
                continue
            if t.dim() > 2:
                t = untile_quant_layout(t)
            t = t[..., :n]
            sd[f"{prefix}.{key}"] = t.T.contiguous() if key == "qweight" else t.contiguous()

    layers = jax_params["layers"]
    lora = {k: tuple(np.asarray(x, np.float32) for x in v) for k, v in layers.items() if k.startswith("lora_")}
    sd = {name: tensor(jax_params[name]) for name in (
        "embed_tokens", "final_norm", "final_norm_bias", "embed_norm", "embed_norm_bias", "embed_positions",
        "lm_head_bias") if name in jax_params}
    if "kv_scales" in layers:
        sd["kv_scales"] = tensor(np.asarray(layers["kv_scales"], np.float32))
    if not args.tie_word_embeddings:
        lm = jax_params["lm_head"]
        if isinstance(lm, dict):
            put_quant("lm_head", lm, args.vocab_size, True)  # always symmetric
        else:
            sd["lm_head"] = tensor(lm).T.contiguous()
    for l in range(args.n_layers):
        for name in ("input_norm", "input_norm_bias", "post_norm", "post_norm_bias", "qkv_bias", "q_bias",
                     "k_bias", "v_bias", "q_norm", "k_norm", "post_attn_norm", "post_ffw_norm", "o_bias",
                     "gate_up_bias", "gate_bias", "up_bias", "down_bias"):
            if name in layers:
                sd[f"layers.{l}.{name}"] = tensor(np.asarray(layers[name])[l])
        for name in ("router", "shared_gate"):
            if name in layers:
                sd[f"layers.{l}.{name}"] = tensor(np.asarray(layers[name])[l]).T.contiguous()
        for part in ("gate", "up", "down"):
            node = layers.get(f"moe_{part}")
            if isinstance(node, dict):
                sd[f"layers.{l}.experts_{part}.qweight"] = tensor(
                    np.asarray(node["qweight"])[l]).transpose(1, 2).contiguous()
                sd[f"layers.{l}.experts_{part}.scales"] = tensor(np.asarray(node["scales"])[l])
            elif node is not None:
                sd[f"layers.{l}.experts_{part}"] = tensor(np.asarray(node)[l]).transpose(1, 2).contiguous()
        for name, n in widths.items():
            if name not in layers:
                continue
            node = layers[name]
            if isinstance(node, dict):
                put_quant(f"layers.{l}.{name}",
                          {k: np.asarray(v)[l] for k, v in node.items()}, n, symmetric)
            else:
                sd[f"layers.{l}.{name}"] = tensor(np.asarray(node)[l]).T.contiguous()
        for name, t in lora_layer_tensors(lora, l).items():
            sd[f"layers.{l}.{name}"] = t
    return sd
