"""ContinuousScheduler — continuous batching with chunked prefill,
preemption, priorities and prefix-cache-aware n/best_of expansion
(counterpart of scalellm_tpu/scheduler/continuous_scheduler.py, synchronous
stepping only: async pipelining, multi-step decode, KV swap and speculative
slots are not ported).

  - intake queue -> priority order (HIGH/NORMAL/LOW, then FCFS)
  - per-step batch under a token budget (max_tokens_per_batch) and a
    sequence budget (max_seqs_per_batch); chunked prefill falls out of the
    per-sequence token budgets
  - preemption of the lowest-priority block-holding request when KV runs out
  - lazy n/best_of expansion after prefill, so siblings share the prompt KV
    through the prefix cache
  - releases the blocks of finished sequences; streams deltas through the
    ResponseHandler
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from scalellm_tpu_torch.engine.batch import Batch
from scalellm_tpu_torch.request.request import Request
from scalellm_tpu_torch.scheduler.response_handler import ResponseHandler
from scalellm_tpu_torch.utils.metrics import COUNTERS, GAUGES, HISTOGRAMS

logger = logging.getLogger(__name__)


@dataclass
class SchedulerOptions:
    max_tokens_per_batch: int = 512
    max_seqs_per_batch: int = 128
    # Intake queue capacity.
    max_pending_requests: int = 100_000


class ContinuousScheduler:
    def __init__(
        self,
        engine,
        options: SchedulerOptions = SchedulerOptions(),
        response_handler: Optional[ResponseHandler] = None,
    ):
        self._engine = engine
        self._options = options
        self._block_manager = engine.block_manager
        self._response_handler = response_handler or ResponseHandler(
            engine.tokenizer, threaded=False
        )
        self._intake: "queue.Queue[Request]" = queue.Queue(
            maxsize=options.max_pending_requests
        )
        # Requests admitted and not yet finished.
        self._requests: List[Request] = []
        self._pending = 0
        self._pending_lock = threading.Lock()

    @property
    def max_seq_tokens(self) -> int:
        """KV capacity available to a single sequence."""
        return self._block_manager.max_seq_tokens

    # ---------------------------------------------------------------- intake

    def schedule(self, request: Request) -> bool:
        """Enqueue a request; False when the queue is full."""
        try:
            self._intake.put_nowait(request)
        except queue.Full:
            return False
        with self._pending_lock:
            self._pending += 1
        COUNTERS.inc("scheduling_pending_requests")
        return True

    @property
    def num_pending_requests(self) -> int:
        with self._pending_lock:
            return self._pending

    # ---------------------------------------------------------------- step

    def step(self, timeout_s: float = 0.5) -> int:
        """Build one batch, run the engine, deliver outputs. Returns the
        number of sequences stepped."""
        batch = self._build_batch(timeout_s)
        if not batch.entries:
            return 0
        COUNTERS.inc("num_engine_steps")
        self._execute_sync(batch)
        return len(batch.entries)

    def _execute_sync(self, batch: Batch) -> None:
        t0 = time.monotonic()
        self._engine.execute_model(batch)
        HISTOGRAMS.observe("execute_model_latency_seconds", time.monotonic() - t0)
        self._process_outputs(batch)

    def run_until_complete(self) -> None:
        """Loop until all scheduled work is done."""
        while True:
            stepped = self.step(timeout_s=0.0)
            if stepped == 0 and self.num_pending_requests == 0 and not self._requests:
                break
        self._response_handler.wait_for_complete()

    # ---------------------------------------------------------------- build

    def _drain_intake(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                self._requests.append(self._intake.get_nowait())
            except queue.Empty:
                if self._requests or timeout_s <= 0:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                try:
                    self._requests.append(
                        self._intake.get(timeout=min(remaining, 0.05))
                    )
                except queue.Empty:
                    continue

    def _finish_request(self, request: Request) -> None:
        for seq in request.sequences:
            self._block_manager.deallocate(seq)
        self._response_handler.on_request_finish(request)
        with self._pending_lock:
            self._pending -= 1
        HISTOGRAMS.observe(
            "end_2_end_latency_seconds", time.monotonic() - request.created_time
        )
        COUNTERS.inc("responsing_rounds" if request.stream else "non_stream_responses")

    def _build_batch(self, timeout_s: float) -> Batch:
        t0 = time.monotonic()
        self._drain_intake(timeout_s)
        opts = self._options

        # Priority, then FCFS.
        self._requests.sort(key=lambda r: (int(r.priority), r.arrival_seq))

        # Retire finished/cancelled requests; release their blocks.
        live: List[Request] = []
        for req in self._requests:
            if req.is_finished():
                self._finish_request(req)
            else:
                live.append(req)
        self._requests = live

        # Lazy n/best_of expansion once the prefill KV exists.
        for req in self._requests:
            if req.should_expand_sequences():
                req.expand_sequences()

        batch = Batch()
        token_budget = opts.max_tokens_per_batch
        seq_budget = opts.max_seqs_per_batch
        for req in self._requests:
            if token_budget <= 0 or seq_budget <= 0:
                break
            for seq in req.sequences:
                if token_budget <= 0 or seq_budget <= 0:
                    break
                if seq.is_finished():
                    continue
                cached = seq.num_kv_cache_tokens()
                uncached = seq.num_tokens - cached
                if uncached <= 0:
                    continue
                # Chunked prefill: clamp to the remaining token budget.
                n = min(uncached, token_budget)
                target = cached + n
                if not self._allocate_with_preemption(req, seq, target, batch):
                    continue  # out of memory even after preemption: wait
                # A prefix-cache hit during allocation may have served part
                # of the prompt from shared blocks — recompute the chunk, and
                # top up blocks if it now reaches further than the target.
                cached = seq.num_kv_cache_tokens()
                n = min(seq.num_tokens - cached, token_budget)
                if n <= 0:
                    continue
                if cached + n > target and not self._block_manager.allocate_blocks_for(
                    seq, cached + n
                ):
                    n = seq.kv_cache_capacity - cached  # what the blocks cover
                    if n <= 0:
                        continue
                batch.add(seq, n)
                token_budget -= n
                seq_budget -= 1

        GAUGES.set("num_running_requests", len(self._requests))
        GAUGES.set("kv_cache_utilization_perc", self._block_manager.kv_cache_utilization)
        GAUGES.set(
            "num_blocks_in_prefix_cache", self._block_manager.num_blocks_in_prefix_cache
        )
        HISTOGRAMS.observe("scheduling_latency_seconds", time.monotonic() - t0)
        return batch

    def _allocate_with_preemption(
        self, req: Request, seq, num_tokens: int, batch: Batch
    ) -> bool:
        """Allocate blocks, preempting lower-priority block holders if needed."""
        if self._block_manager.allocate_blocks_for(seq, num_tokens):
            return True
        # Preempt from the lowest-priority end; never `req` itself or a
        # request already in this step's batch.
        in_batch = {id(e.seq) for e in batch.entries}
        for victim in sorted(
            self._requests, key=lambda r: (int(r.priority), r.arrival_seq), reverse=True
        ):
            if victim is req:
                continue
            if any(id(s) in in_batch for s in victim.sequences):
                continue
            if not any(s.blocks for s in victim.sequences):
                continue
            for s in victim.sequences:
                self._block_manager.deallocate(s)  # re-prefills later
            COUNTERS.inc("num_preempted_requests")
            if self._block_manager.allocate_blocks_for(seq, num_tokens):
                return True
        return self._block_manager.allocate_blocks_for(seq, num_tokens)

    # ---------------------------------------------------------------- output

    def _process_outputs(self, batch: Batch) -> None:
        touched = []
        seen = set()
        for e in batch.entries:
            req = getattr(e.seq, "request", None)
            if req is not None and id(req) not in seen:
                seen.add(id(req))
                touched.append(req)
        for req in touched:
            # Release the blocks of finished sequences early.
            for seq in req.sequences:
                if seq.is_finished() and seq.blocks:
                    self._block_manager.deallocate(seq)
            if req.is_finished():
                if req in self._requests:
                    self._requests.remove(req)
                    self._finish_request(req)
            elif req.stream:
                self._response_handler.on_request_stream(req)
