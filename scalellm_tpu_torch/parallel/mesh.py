"""Process groups for tensor and data parallelism (counterpart of
scalellm_tpu/parallel/mesh.py).

The reference builds a jax.sharding.Mesh over ("dp", "tp") and lets XLA lay
the collectives inside one program. Here one process drives one device and
the collectives run between processes over torch.distributed
(parallel/collectives.py), so a mesh is this process's view of the process
groups: rank r is (dp_rank, tp_rank) = divmod(r, tp), its tp group the tp
ranks of its dp row, its dp group the dp ranks of its tp column. Beside them
every rank keeps a CPU group (gloo) over all ranks for the step inputs'
broadcasts (parallel/multihost.py), so that host arrays never go through
NCCL.

The tp group has the default group's backend: "nccl" where each rank has a
card of its own, "gloo" on the CPU and where ranks share a card (NCCL
refuses two ranks on one device). A mesh of one process (single_mesh) has
no groups, and every collective is the identity on it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import torch

logger = logging.getLogger(__name__)


@dataclass
class Mesh:
    tp_size: int = 1
    dp_size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    # "" (one process), "gloo" or "nccl": the tp group's backend.
    backend: str = ""
    tp_group: Any = None
    dp_group: Any = None
    cpu_group: Any = None

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp_size

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp_size

    @property
    def world_size(self) -> int:
        return self.tp_size * self.dp_size


def single_mesh(device: Union[str, torch.device] = "cpu") -> Mesh:
    """The mesh of one process on `device`: no groups."""
    return Mesh(device=torch.device(device))


def _this_device(devices, rank: int) -> torch.device:
    if devices is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu")
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    return torch.device(devices[rank])


def make_mesh(tp: int = 1, dp: int = 1,
              devices: Optional[Union[str, torch.device, Sequence]] = None) -> Mesh:
    """The mesh of this process in a world of tp * dp ranks, which
    parallel/multihost.init_distributed has joined (a world of one needs
    none). `devices`: this process's device, or one device a rank (indexed
    by rank); by default the current card, else the CPU. Every rank must
    call it, in the same order as the others: each group is made by all
    ranks together."""
    import torch.distributed as dist

    n = tp * dp
    if n == 1 and not dist.is_initialized():
        return single_mesh(_this_device(devices, 0))
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs init_distributed first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"dp*tp ({dp}*{tp}) != world size ({world})")
    rank = dist.get_rank()
    device = _this_device(devices, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    from scalellm_tpu_torch.parallel import multihost

    mesh = Mesh(tp_size=tp, dp_size=dp, rank=rank, device=device, backend=dist.get_backend(),
                cpu_group=multihost.cpu_group())
    for d in range(dp):
        group = dist.new_group([d * tp + t for t in range(tp)])
        if d == mesh.dp_rank:
            mesh.tp_group = group
    for t in range(tp):
        group = dist.new_group([d * tp + t for d in range(dp)])
        if t == mesh.tp_rank:
            mesh.dp_group = group
    return mesh


def collective_smoke_test(mesh: Mesh) -> bool:
    """One small all_reduce at start-up (the reference's NCCL smoke test,
    llm_engine.cpp:98-107): ones summed over the CPU group (the world) and
    over the tp group on this rank's device. Raises RuntimeError if a sum
    is wrong; True otherwise (also on a mesh of one process)."""
    if mesh.world_size == 1:
        return True
    import torch.distributed as dist

    from scalellm_tpu_torch.parallel import collectives

    ones = torch.ones(1, dtype=torch.int64)
    dist.all_reduce(ones, group=mesh.cpu_group)
    tp_sum = collectives.all_reduce(torch.ones(1, dtype=torch.float32, device=mesh.device), mesh)
    got = (int(ones.item()), float(tp_sum.item()))
    if got != (mesh.world_size, float(mesh.tp_size)):
        raise RuntimeError(f"collective smoke test failed: sums {got}, want ({mesh.world_size}, {mesh.tp_size})")
    return True
