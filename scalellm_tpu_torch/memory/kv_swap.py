"""KV swap-out preemption: a preempted sequence's KV pages staged in host
memory and written back when it is scheduled again
(counterpart of scalellm_tpu/memory/kv_swap.py).

Without it, a preempted sequence drops its blocks and re-prefills later.
With a host byte budget (host_swap_bytes), the scheduler stages a victim's
pages in host memory before it releases its blocks, and restores them into
fresh blocks when the sequence runs again: a swap-in moves the KV bytes once
over PCIe where a recompute runs the model over every token again.

  - HostKVPool holds each sequence's staged pages (a host tensor, pinned on
    a CUDA device) under a byte budget with LRU eviction. An evicted victim
    falls back to the recompute: swap changes the cost, never the result.
  - KVSwapper binds the pool to the Executor: swap_out starts the copy of
    the sequence's pages ([L, P, page, ...] indexed on the page dim) to host
    memory behind an event (Executor.fetch_pages_async) and returns;
    finalize_staging waits for the copies started before (the scheduler
    calls it once a build, by when the step behind them has run);
    swap_in allocates fresh blocks (the prefix cache bypassed: the staged
    data covers generated tokens too, which the prefix cache never serves)
    and writes the staged pages into them in place
    (Executor.restore_pages), restoring the sequence's KV counter.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from scalellm_tpu_torch.utils.metrics import COUNTERS, GAUGES

if TYPE_CHECKING:
    from scalellm_tpu_torch.request.sequence import Sequence


@dataclass
class SwapEntry:
    # [L, n_pages, page_size, ...] staged page contents: a host tensor, or
    # while its copy may still run, the Executor's PendingFetch; finalize()
    # waits for the copy and keeps the host tensor.
    data: object
    num_kv_tokens: int  # the KV counter to restore on swap-in

    @property
    def nbytes(self) -> int:
        return self.data.nbytes

    def finalize(self) -> None:
        if hasattr(self.data, "wait"):
            self.data = self.data.wait()


class HostKVPool:
    """Byte-budgeted LRU pool of staged KV pages, keyed by sequence id."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[int, SwapEntry]" = OrderedDict()
        self._used = 0

    @property
    def used_bytes(self) -> int:
        return self._used

    def __contains__(self, seq_id: int) -> bool:
        return seq_id in self._entries

    def put(self, seq_id: int, entry: SwapEntry) -> bool:
        nbytes = entry.nbytes
        if nbytes > self.max_bytes:
            return False
        while self._used + nbytes > self.max_bytes and self._entries:
            _, old = self._entries.popitem(last=False)  # LRU: the oldest first
            self._used -= old.nbytes
            COUNTERS.inc("num_swap_evictions")
        self._entries[seq_id] = entry
        self._used += nbytes
        GAUGES.set("kv_swap_pool_bytes", float(self._used))
        return True

    def get(self, seq_id: int) -> Optional[SwapEntry]:
        return self._entries.get(seq_id)

    def pop(self, seq_id: int) -> Optional[SwapEntry]:
        entry = self._entries.pop(seq_id, None)
        if entry is not None:
            self._used -= entry.nbytes
            GAUGES.set("kv_swap_pool_bytes", float(self._used))
        return entry

    def discard(self, seq_id: int) -> None:
        self.pop(seq_id)


class KVSwapper:
    """Swap-out and swap-in of a sequence's KV pages through the Executor's
    cache. The scheduler calls swap_out on preemption (before it releases
    the victim's blocks), swap_in when the sequence is scheduled again, and
    discard when its request retires with an entry still staged."""

    def __init__(self, executor, block_manager, block_size: int, pool: HostKVPool):
        self._executor = executor
        self._bm = block_manager
        self._block_size = block_size
        self._pool = pool
        self._staging: List[SwapEntry] = []  # entries whose host copy may still run

    @property
    def pool(self) -> HostKVPool:
        return self._pool

    def has_entry(self, seq: "Sequence") -> bool:
        return seq.seq_id in self._pool

    def _page_bytes(self) -> int:
        kv = self._executor.kv_cache
        return kv.shape[0] * int(np.prod(kv.shape[2:])) * kv.element_size()

    def staging_fits(self, seq: "Sequence") -> bool:
        """True when preempting `seq` can stage its pages in the pool's free
        space, without LRU-evicting other sequences' staged pages (which
        would turn their swap-in back into a recompute): the scheduler's
        swap-aware victim choice."""
        n_kv = seq.num_kv_cache_tokens()
        if n_kv <= 0 or not seq.blocks:
            return True  # nothing to stage
        if self._executor.kv_cache is None:
            return False
        n_pages = (n_kv + self._block_size - 1) // self._block_size
        return n_pages * self._page_bytes() <= self._pool.max_bytes - self._pool.used_bytes

    def swap_out(self, seq: "Sequence") -> bool:
        """Start staging the sequence's computed pages; False when there is
        nothing to stage or the pool refuses it. Its blocks may be released
        at once: a step that overwrites them is enqueued after the gather."""
        n_kv = seq.num_kv_cache_tokens()
        if n_kv <= 0 or not seq.blocks:
            return False
        n_pages = (n_kv + self._block_size - 1) // self._block_size
        page_ids = np.asarray(seq.block_ids()[:n_pages], np.int32)
        entry = SwapEntry(self._executor.fetch_pages_async(page_ids), n_kv)
        if not self._pool.put(seq.seq_id, entry):
            return False
        self._staging.append(entry)
        COUNTERS.inc("num_swap_out")
        COUNTERS.inc("kv_swap_out_bytes", entry.nbytes)
        return True

    def finalize_staging(self) -> None:
        """Wait for the host copies started since the last call (they ran
        behind the step enqueued after them), keeping their host tensors."""
        pending, self._staging = self._staging, []
        for entry in pending:
            entry.finalize()

    def swap_in(self, seq: "Sequence") -> bool:
        """Restore a staged sequence: fresh blocks (prefix cache bypassed),
        the staged pages written into them, the KV counter restored. False
        (the entry kept) when the blocks cannot be allocated: the sequence
        then waits rather than recomputes."""
        entry = self._pool.get(seq.seq_id)
        if entry is None:
            return False
        entry.finalize()  # its host copy may still run
        assert not seq.blocks, "swap_in expects a sequence without blocks"
        # Room for the whole sequence (the restored KV and the next token).
        if not self._bm.allocate_fresh_blocks_for(seq, seq.num_tokens):
            return False
        n_pages = entry.data.shape[1]
        page_ids = np.asarray(seq.block_ids()[:n_pages], np.int32)
        self._executor.restore_pages(page_ids, entry.data)
        seq.restore_kv_tokens(entry.num_kv_tokens)
        self._pool.pop(seq.seq_id)
        COUNTERS.inc("num_swap_in")
        COUNTERS.inc("kv_swap_in_bytes", entry.nbytes)
        return True

    def discard(self, seq: "Sequence") -> None:
        self._pool.discard(seq.seq_id)
