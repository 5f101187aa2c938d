"""The collectives of tensor, sequence and expert parallelism (the
reference's lax.psum, lax.all_gather, lax.psum_scatter and all_to_all,
which its model emits inside shard_map), over a mesh's tp group
(parallel/mesh.py).

Each is the identity on a mesh of one rank (or mesh None). Callers reduce
row-parallel partials in float32, as the reference's psum of _proj's f32
partial is: a bf16 all_reduce on gloo would sum in bf16.

Every backend runs the same calls: torch.distributed's tensor collectives
(all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
all_to_all_single) on the rank's own tensors. NCCL takes them on the card;
gloo (the CPU, and ranks that share a card) takes CUDA tensors too and
moves them through host memory itself.

Each collective runs inside a torch.profiler range named "tp.<collective>",
which a trace reads as the time spent in collectives (on gloo with CUDA
tensors it includes the copies through the host and the wait for the work
queued on the card before them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from scalellm_tpu_torch.parallel.mesh import Mesh

RANGES = ("tp.all_reduce", "tp.all_gather", "tp.reduce_scatter", "tp.all_to_all")


def _single(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.tp_size == 1


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of x over the tp group (the reference's lax.psum); a
    contiguous x is reduced in place."""
    if _single(mesh):
        return x
    import torch.distributed as dist

    x = x.contiguous()
    with torch.profiler.record_function("tp.all_reduce"):
        dist.all_reduce(x, group=mesh.tp_group)
    return x


def all_gather(x: torch.Tensor, dim: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """The tp ranks' x concatenated in rank order along `dim` (the
    reference's lax.all_gather(..., tiled=True))."""
    if _single(mesh):
        return x
    import torch.distributed as dist

    h = x.movedim(dim, 0).contiguous()
    out = h.new_empty((mesh.tp_size * h.shape[0], *h.shape[1:]))
    with torch.profiler.record_function("tp.all_gather"):
        dist.all_gather_into_tensor(out, h, group=mesh.tp_group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of x over the tp group, of which this rank keeps chunk
    tp_rank of `dim` (the reference's lax.psum_scatter(..., tiled=True));
    x's size along `dim` must divide by tp."""
    if _single(mesh):
        return x
    import torch.distributed as dist

    tp = mesh.tp_size
    if x.shape[dim] % tp:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide by tp {tp}")
    h = x.movedim(dim, 0).contiguous()
    out = h.new_empty((h.shape[0] // tp, *h.shape[1:]))
    with torch.profiler.record_function("tp.reduce_scatter"):
        dist.reduce_scatter_tensor(out, h, group=mesh.tp_group)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, in_splits: Sequence[int], out_splits: Sequence[int],
               mesh: Optional[Mesh]) -> torch.Tensor:
    """Rows in_splits[d] of x (in order, along dim 0) go to rank d; the
    result holds out_splits[s] rows from each rank s, in rank order. The
    splits are host integers and may be uneven."""
    if _single(mesh):
        return x
    import torch.distributed as dist

    x = x.contiguous()
    out = x.new_empty((sum(out_splits), *x.shape[1:]))
    with torch.profiler.record_function("tp.all_to_all"):
        dist.all_to_all_single(out, x, list(out_splits), list(in_splits), group=mesh.tp_group)
    return out
