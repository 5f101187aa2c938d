"""Multi-process coordination for the distributed engine (counterpart of
scalellm_tpu/parallel/multihost.py, over torch.distributed).

In the reference one jitted program spans every host, and the hosts must
enter it in lockstep on the same step inputs; here tensor parallelism is
one process a rank even on one host, and the processes must run the same
step, collectives included, in the same order. Rank 0 (the driver)
schedules; this module broadcasts the resulting step inputs, host numpy
arrays, over the CPU (gloo) group so that every rank runs the same step
(engine/distributed.py).

Usage:
    init_distributed("host:port", N, rank)  # joins the world, tcp:// rendezvous
    mesh = make_pod_mesh(tp=N, device=...)  # process groups (parallel/mesh.py)
    if is_driver(): mi, si = scheduler...   # rank 0 builds the batch
    mi, si = broadcast_step_inputs(mi, si)  # everyone gets rank 0's inputs
    outs = executor.execute(mi, si)         # the same step on every rank

Timeouts: the world's collectives (the model's) fail after
COLLECTIVE_TIMEOUT_S; the CPU group, where a follower waits for the next
step however long the driver stays idle, after IDLE_TIMEOUT_S. A rank whose
peer process has died gets gloo's connection error at its next collective.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from datetime import timedelta
from typing import Any, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

COLLECTIVE_TIMEOUT_S = 600.0
IDLE_TIMEOUT_S = 7 * 24 * 3600.0

_state = {"cpu_group": None}


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
    timeout_s: float = COLLECTIVE_TIMEOUT_S,
) -> None:
    """Join the world of num_processes ranks as rank process_id, with a
    tcp:// rendezvous at coordinator_address ("host:port", served by rank
    0), then make the world's CPU group. No address: a world of one
    process, nothing to join. Already joined: nothing to do."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator address")
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    _state["cpu_group"] = dist.new_group(backend="gloo", timeout=timedelta(seconds=IDLE_TIMEOUT_S))
    logger.info("rank %d of %d joined %s (%s)", process_id, num_processes, coordinator_address, backend)


def shutdown_distributed() -> None:
    """Leave the world (every group of it)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _state["cpu_group"] = None


def cpu_group():
    """The world's CPU (gloo) group made by init_distributed."""
    if _state["cpu_group"] is None:
        raise RuntimeError("init_distributed first")
    return _state["cpu_group"]


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_driver() -> bool:
    """True on the rank that schedules (rank 0; the reference's host 0)."""
    return process_index() == 0


def make_pod_mesh(tp: int = 0, dp: int = 1, device=None):
    """The mesh over every rank of the world: (dp, tp); tp=0 puts all ranks
    in one tp group. `device`: this rank's device."""
    from scalellm_tpu_torch.parallel.mesh import make_mesh

    n = process_count()
    if tp <= 0:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp ({dp}*{tp}) != processes ({n})")
    return make_mesh(tp, dp, device)


def _leaves(tree: Any) -> List[np.ndarray]:
    """The numpy arrays of a tree of dataclasses, tuples, lists and dicts,
    in a fixed order (None leaves skipped)."""
    if tree is None:
        return []
    if isinstance(tree, np.ndarray):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [a for f in dataclasses.fields(tree) for a in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _leaves(t)]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    raise TypeError(f"broadcast_step_inputs: cannot broadcast a {type(tree).__name__}")


def _rebuild(tree: Any, arrays: List[np.ndarray]) -> Any:
    """`tree` with its arrays replaced, in _leaves order, by `arrays`."""
    if tree is None:
        return None
    if isinstance(tree, np.ndarray):
        return arrays.pop(0)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), arrays)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, arrays) for t in tree)
    return {k: _rebuild(tree[k], arrays) for k in sorted(tree)}


def broadcast_step_inputs(*trees: Any) -> Tuple[Any, ...]:
    """Broadcast rank 0's trees of host numpy arrays (ModelInputs /
    SamplingInputs, headers) to every rank; the others pass placeholders of
    the same structure, shapes and dtypes and get rank 0's values. One
    broadcast of all leaves' bytes over the CPU group. Pass-through on one
    process."""
    if process_count() == 1:
        return trees
    import torch
    import torch.distributed as dist

    leaves = [np.ascontiguousarray(a) for t in trees for a in _leaves(t)]
    sizes = [a.nbytes for a in leaves]
    buf = torch.empty(sum(sizes), dtype=torch.uint8)
    view = buf.numpy()
    driver = is_driver()
    if driver:
        off = 0
        for a, n in zip(leaves, sizes):
            view[off : off + n] = a.reshape(-1).view(np.uint8)
            off += n
    dist.broadcast(buf, src=0, group=cpu_group())
    if driver:
        return trees
    out, off = [], 0
    for a, n in zip(leaves, sizes):
        out.append(view[off : off + n].view(a.dtype).reshape(a.shape).copy())
        off += n
    return tuple(_rebuild(t, out) for t in trees)


def broadcast_with_timeout(tree: Any, timeout: Optional[float] = None) -> Any:
    """broadcast_step_inputs for ONE tree, bounded by `timeout` seconds.

    A follower waits here for the driver's next step; a driver that is
    alive but wedged would hold it forever. The collective runs on a daemon
    thread; if it misses the deadline this raises RuntimeError in the caller
    so the follower can exit loudly (the abandoned thread may stay blocked:
    the only recovery from a lost driver is process exit). A driver that
    died ends the wait with gloo's connection error, raised here too."""
    if timeout is None:
        return broadcast_step_inputs(tree)[0]
    q: "queue.Queue[tuple[bool, Any]]" = queue.Queue()

    def _run():
        try:
            q.put((True, broadcast_step_inputs(tree)[0]))
        except Exception as e:  # collective/runtime errors count as failure
            q.put((False, e))

    t = threading.Thread(target=_run, daemon=True, name="mh-bcast")
    t.start()
    try:
        ok, val = q.get(timeout=timeout)
    except queue.Empty:
        raise RuntimeError(
            f"multihost broadcast timed out after {timeout:.1f}s — the "
            "driver is unreachable (dead or wedged); exiting"
        ) from None
    if not ok:
        raise RuntimeError(f"multihost broadcast failed: {val}") from val
    return val


def collective_smoke_test(mesh) -> bool:
    """The start-up all_reduce of parallel/mesh.py: True, or RuntimeError."""
    from scalellm_tpu_torch.parallel.mesh import collective_smoke_test as smoke

    return smoke(mesh)
