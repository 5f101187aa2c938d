"""Mixture-of-experts MLP: router, sort-by-expert dispatch, grouped expert
matmuls, weighted combine (counterpart of scalellm_tpu/layers/moe.py,
replicated dispatch).

The (token, slot) pairs of the top-k routing are sorted by expert (a stable
sort, as jnp.argsort is), so each expert's rows are contiguous; the group
sizes come from the sorted ids without a device-to-host sync. The expert
matmuls are grouped GEMMs (ops/grouped_matmul.py, K6, a hook the caller may
swap for the plain version). Rows are not padded: K6 takes any row count,
so the reference's 128-row alignment (row_align) has no counterpart here.

Expert weights are stored [E, N, K] (torch's [out, in] per expert): gate
and up [E, F, D], down [E, D, F]; the router [E, D].

Quantized experts (int4/int8, ops/moe_quant.py's layout) go through
quant_expert_ffn: gate and up in one routed call (K8 on decode-sized
steps), then down (K7); steps with more rows dequantize and run K6, as the
reference does. single_token_layout builds the reference's sort-free T=1
layout for them: the token's k experts are distinct, so row j belongs to
top-k slot j's expert and no sort is needed.

routed_experts is the routed part of every MoE model's layer (DecoderModel's
Mixtral and Qwen2-MoE, MLADecoderModel's DeepSeek-V2): given the router's
top-k, it dispatches, runs the experts (dense or quantized) and combines.

Expert parallelism: DecoderModel shards the experts over its tp ranks
where tp divides E (the reference's replicated dispatch, moe_mlp's
ep_axis): each rank remaps the routed ids to its own E / tp experts, sends
the others' pairs to the overflow group E / tp with weight 0, and the
layer's all_reduce adds the ranks' outputs. moe_mlp_a2a is the reference's
all-to-all dispatcher for tokens sharded over the expert ranks, on
parallel/collectives.py's all_to_all with uneven splits; as in the
reference, no model calls it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from scalellm_tpu_torch.layers.activations import act_with_mul
from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul
from scalellm_tpu_torch.parallel import collectives as C
from scalellm_tpu_torch.ops.moe_quant import (
    active_experts,
    expert_starts,
    grouped_quant_matmul,
    grouped_quant_matmul_pair,
    takes_decode_kernel,
)


def softmax_topk(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                 norm_topk_prob: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing weights and experts [T, k]: softmax over the router logits in
    f32, top-k, optionally renormalised over the k."""
    probs = torch.softmax(x.float() @ router_w.float().T, dim=-1)
    topk_w, topk_e = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return topk_w, topk_e


def dispatch(topk_e: torch.Tensor, n_experts: int):
    """Sort the (token, slot) pairs by expert. Returns (order: the pair
    index of each sorted row, token_of: its token, group_sizes i32[E])."""
    flat_e = topk_e.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    edges = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, device=flat_e.device, dtype=sorted_e.dtype))
    group_sizes = (edges[1:] - edges[:-1]).to(torch.int32)
    return order, order // topk_e.shape[-1], group_sizes


def expert_ffn(xs: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor, down_w: torch.Tensor,
               group_sizes: torch.Tensor, act: str = "silu",
               gmm: Callable = grouped_matmul) -> torch.Tensor:
    """The gated expert FFN over expert-sorted rows, f32 [R, D]; rows past
    the last covered group are zeros (the grouped matmul leaves them
    unwritten)."""
    g = gmm(xs, gate_w, group_sizes)
    u = gmm(xs, up_w, group_sizes)
    h = act_with_mul(act, g, u).to(xs.dtype)
    y = gmm(h, down_w, group_sizes)
    covered = torch.arange(y.shape[0], device=y.device) < group_sizes.sum()
    return torch.where(covered[:, None], y, 0.0)


def quant_expert_ffn(xs: torch.Tensor, gate, up, down, group_sizes: torch.Tensor, act: str = "silu", *,
                     active=None, starts=None, max_active: int = 0, variant: str = "") -> torch.Tensor:
    """The gated expert FFN over quantized experts (modules holding qweight
    and scales), f32 [R, D], 0 on rows outside every group. active / starts
    give an explicit layout (single_token_layout); by default the rows are
    sorted by expert, and where all three calls take the decode kernel the
    active list and starts are computed here once, on the device, for all
    of them. variant goes to ops/moe_quant.py's dispatcher."""
    R, K = xs.shape
    if active is None and starts is None and all(
            takes_decode_kernel(R, k, w.qweight, w.scales)
            for k, w in ((K, gate), (K, up), (gate.qweight.shape[1], down))):
        active, starts = active_experts(group_sizes, max_active), expert_starts(group_sizes)
    kw = dict(active=active, starts=starts, max_active=max_active, variant=variant)
    g, u = grouped_quant_matmul_pair(xs, gate.qweight, gate.scales, up.qweight, up.scales, group_sizes, **kw)
    h = act_with_mul(act, g, u).to(xs.dtype)
    return grouped_quant_matmul(h, down.qweight, down.scales, group_sizes, **kw)


def single_token_layout(topk_e: torch.Tensor, topk_w: torch.Tensor, n_experts: int):
    """The reference's sort-free layout of one token's k distinct experts:
    (rows Tp = k rounded up to 8, group sizes, starts and the active list,
    each i32 and on the device, and the f32 weight of each row, 0 on the
    rows past k). Row j belongs to top-k slot j's expert."""
    k = topk_e.shape[-1]
    dev = topk_e.device
    e_sel = topk_e[0].to(torch.int32)
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=dev).index_fill_(0, e_sel.long(), 1)
    starts = torch.zeros(n_experts, dtype=torch.int32, device=dev).index_copy_(
        0, e_sel.long(), torch.arange(k, dtype=torch.int32, device=dev))
    Tp = -(-k // 8) * 8
    w_col = torch.zeros(Tp, dtype=torch.float32, device=dev)
    w_col[:k] = topk_w[0].float()
    return Tp, sizes, starts, e_sel, w_col


def single_token_fits(k: int, hidden: int, gate, down) -> bool:
    """Whether both routed calls of the T=1 layout (k rows) take the decode
    kernel, which that layout needs. Down's K is gate's N, whatever the
    bits."""
    return (takes_decode_kernel(k, hidden, gate.qweight, gate.scales)
            and takes_decode_kernel(k, gate.qweight.shape[1], down.qweight, down.scales))


def routed_experts(x: torch.Tensor, topk_w: torch.Tensor, topk_e: torch.Tensor, gate, up, down,
                   act: str = "silu", *, gmm: Callable = grouped_matmul, qexperts: Callable = quant_expert_ffn,
                   t1_fits: Optional[Callable[[], bool]] = None) -> torch.Tensor:
    """x [T, D] through the experts the router picked (topk_w, topk_e [T,
    k]), weighted and summed: f32 [T, D]. Dense experts (tensors [E, N, K])
    take the sorted dispatch and three grouped GEMMs; quantized ones
    (modules holding qweight and scales) the T=1 layout where T = 1 and
    t1_fits() (by default single_token_fits) allows it, else the sorted
    dispatch through qexperts. The work is sized from shapes alone
    (max_active = min(E, T * k)), so a CUDA graph can capture it."""
    k, T = topk_e.shape[-1], x.shape[0]
    if isinstance(gate, torch.Tensor):
        order, token_of, group_sizes = dispatch(topk_e, gate.shape[0])
        y = expert_ffn(x[token_of], gate, up, down, group_sizes, act, gmm)
        return combine(y, topk_w, order, token_of, T)
    E = gate.qweight.shape[0]
    if T == 1 and (t1_fits() if t1_fits is not None else single_token_fits(k, x.shape[1], gate, down)):
        Tp, sizes, starts, active, w_col = single_token_layout(topk_e, topk_w, E)
        y = qexperts(x.expand(Tp, -1).contiguous(), gate, up, down, sizes, act,
                     active=active, starts=starts, max_active=min(E, k))
        return (y * w_col[:, None]).sum(dim=0, keepdim=True)
    order, token_of, group_sizes = dispatch(topk_e, E)
    y = qexperts(x[token_of], gate, up, down, group_sizes, act, max_active=min(E, T * k))
    return combine(y, topk_w, order, token_of, T)


def combine(y: torch.Tensor, topk_w: torch.Tensor, order: torch.Tensor, token_of: torch.Tensor,
            n_tokens: int) -> torch.Tensor:
    """Add each token's k expert rows (y, sorted by expert), weighted by
    their routing weights: f32 [T, D]. The inverse of `order`
    gathers them back into top-k slot order, [T, k, D], and one reduction
    adds them, so no atomics and the same bits on every run. (The
    reference's scatter adds a token's rows in sorted-row order instead;
    the same sum in another f32 order.)"""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    rows = y[inv].view(n_tokens, -1, y.shape[-1])
    return (rows * topk_w.float()[..., None]).sum(dim=1)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
            down_w: torch.Tensor, top_k: int, norm_topk_prob: bool = False, act: str = "silu",
            gmm: Callable = grouped_matmul) -> torch.Tensor:
    """x [T, D] -> f32 [T, D]: softmax top-k routing over router_w [E, D],
    then the experts' gated FFNs."""
    topk_w, topk_e = softmax_topk(x, router_w, top_k, norm_topk_prob)
    return routed_experts(x, topk_w, topk_e, gate_w, up_w, down_w, act, gmm=gmm)


def moe_mlp_a2a(x: torch.Tensor, router_w: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
                down_w: torch.Tensor, top_k: int, norm_topk_prob: bool = False, act: str = "silu", mesh=None,
                gmm: Callable = grouped_matmul) -> torch.Tensor:
    """All-to-all expert-parallel MoE (the reference's moe_mlp_a2a,
    scalellm_tpu/layers/moe.py:144-230) over the tp ranks of `mesh`: x
    [T_local, D] this rank's tokens, router_w [E, D] whole, gate_w / up_w
    [E_local, F, D] and down_w [E_local, D, F] this rank's experts (expert e
    lives on rank e // E_local). Returns this rank's f32 [T_local, D],
    final (no all_reduce after it).

    The (token, slot) pairs sorted by global expert id are grouped by owner
    rank and expert-sorted within each rank's chunk; the ranks' send counts
    (an all_gather, read on the host: the splits of all_to_all are host
    integers) give both exchanges' uneven splits. After the forward
    exchange the received chunks are re-sorted by local expert for the
    grouped matmul; both sorts are inverted on the way back."""
    T_l, D = x.shape
    E, E_l = router_w.shape[0], gate_w.shape[0]
    if E % E_l:
        raise ValueError(f"{E} experts do not split into ranks of {E_l}")
    ep = E // E_l
    if ep != (mesh.tp_size if mesh is not None else 1):
        raise ValueError(f"{E} experts of {E_l} a rank need {ep} ranks")
    me = mesh.tp_rank if mesh is not None else 0
    topk_w, topk_e = softmax_topk(x, router_w, top_k, norm_topk_prob)
    flat_e = topk_e.reshape(-1)
    e_sorted, order1 = torch.sort(flat_e, stable=True)
    send = torch.bincount(flat_e // E_l, minlength=ep)
    counts = C.all_gather(send[None], 0, mesh).tolist()  # [src][dst]
    in_splits = counts[me]
    out_splits = [counts[src][me] for src in range(ep)]
    recv_x = C.all_to_all(x[order1 // top_k], in_splits, out_splits, mesh)
    recv_e = C.all_to_all(e_sorted[:, None], in_splits, out_splits, mesh)[:, 0]
    local_e, order2 = torch.sort(recv_e - me * E_l, stable=True)
    group_sizes = torch.bincount(local_e, minlength=E_l).to(torch.int32)
    y = expert_ffn(recv_x[order2], gate_w, up_w, down_w, group_sizes, act, gmm)
    y_recv = torch.empty_like(y)
    y_recv[order2] = y
    y_back = C.all_to_all(y_recv, out_splits, in_splits, mesh)
    y_flat = torch.empty_like(y_back)
    y_flat[order1] = y_back
    return (y_flat.view(T_l, top_k, D) * topk_w.float()[..., None]).sum(dim=1)
