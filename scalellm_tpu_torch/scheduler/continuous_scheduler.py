"""ContinuousScheduler — continuous batching with chunked prefill,
preemption, priorities, prefix-cache-aware n/best_of expansion, async
stepping and multi-step decode
(counterpart of scalellm_tpu/scheduler/continuous_scheduler.py).

  - intake queue -> priority order (HIGH/NORMAL/LOW, then FCFS)
  - per-step batch under a token budget (max_tokens_per_batch) and a
    sequence budget (max_seqs_per_batch); chunked prefill falls out of the
    per-sequence token budgets
  - preemption of the lowest-priority block-holding request when KV runs out;
    with the engine's KV swapper (host_swap_bytes) the victim's pages are
    staged in host memory and restored when it runs again, and at equal
    priority a victim whose pages fit the pool's free space goes first
  - lazy n/best_of expansion after prefill, so siblings share the prompt KV
    through the prefix cache
  - releases the blocks of finished sequences; streams deltas through the
    ResponseHandler
  - async stepping (enable_async_scheduling): one step in flight; the next
    is built and dispatched before the previous one's outputs are fetched,
    its pending tokens merged on the device
  - multi-step decode (num_decode_steps = N): a decode-only batch runs N
    micro-steps in one dispatch; each decode sequence reserves
    max(k, N - 1) extra KV slots, k the speculative tokens a round writes
    (num_speculative_tokens)
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

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
    # Async stepping: dispatch step N+1 (its pending tokens merged on the
    # device) before fetching step N's outputs, so the host's fetch and batch
    # prep overlap the device's step. Batches with penalties, guided
    # decoding or prompt logprobs run synchronously (Batch.needs_sync).
    enable_async_scheduling: bool = True
    # Multi-step decode: a decode-only batch runs N micro-steps per dispatch
    # (one graph replay with CUDA graphs on). A sequence that finishes
    # mid-window drops up to N - 1 samples. Batches that need per-token host
    # feedback run single-step (Batch.can_multi_step).
    num_decode_steps: int = 1
    # Extra KV slots a decode sequence reserves for a speculative round's
    # proposals.
    num_speculative_tokens: int = 0


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
        # KV swap-out preemption (memory/kv_swap.py): with the engine's
        # swapper a victim's pages are staged in host memory and restored
        # when it is scheduled again, instead of re-prefilled.
        self._swapper = getattr(engine, "kv_swapper", None)
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
        self._async = options.enable_async_scheduling and getattr(engine, "supports_async", False)
        self._multi_n = (options.num_decode_steps
                         if options.num_decode_steps > 1 and getattr(engine, "supports_multi_step", False)
                         else 1)
        # The dispatched step whose outputs are not fetched yet: (Batch, HostOutputs).
        self._inflight: Optional[Tuple[Batch, object]] = None
        # Set when a pipelined build could not allocate: the next step runs
        # synchronously, where preemption can make room.
        self._starved = False

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
        number of sequences stepped.

        With async stepping the steady state keeps ONE step in flight: build
        and dispatch step N+1 (its pending tokens read step N's samples on
        the device), then fetch and deliver step N."""
        if self._inflight is not None and self._multi_n > 1:
            # Multi-step and async do not compose (the reference's rule): a
            # pipelined build marks rows pending, which disqualifies
            # can_multi_step. Drain first.
            self._resolve_inflight()
        if self._inflight is not None:
            # Build the next batch before resolving the in-flight step.
            nxt = self._build_batch(0.0, pipelined=True)
            if nxt.entries:
                COUNTERS.inc("num_engine_steps")
            if nxt.entries and not self._starved and not nxt.needs_sync():
                outs = self._engine.dispatch_model(nxt, prev_outs=self._inflight[1])
                resolved = self._resolve_inflight()
                self._inflight = (nxt, outs)
                COUNTERS.inc("num_async_steps")
                return max(len(nxt.entries), resolved)
            # This batch cannot be pipelined: drain, then run it
            # synchronously (its pending rows resolve first).
            resolved = self._resolve_inflight()
            if not nxt.entries:
                return resolved
            self._execute_sync(nxt)
            return len(nxt.entries)

        batch = self._build_batch(timeout_s)
        if not batch.entries:
            return 0
        COUNTERS.inc("num_engine_steps")
        if self._multi_n > 1 and batch.can_multi_step():
            t0 = time.monotonic()
            self._engine.execute_model_multi(batch, self._multi_n)
            HISTOGRAMS.observe("execute_model_latency_seconds", time.monotonic() - t0)
            self._process_outputs(batch)
            COUNTERS.inc("num_multi_steps")
            return len(batch.entries)
        if self._async and not batch.needs_sync():
            self._inflight = (batch, self._engine.dispatch_model(batch))
            COUNTERS.inc("num_async_steps")
            return len(batch.entries)
        self._execute_sync(batch)
        return len(batch.entries)

    def _execute_sync(self, batch: Batch) -> None:
        t0 = time.monotonic()
        self._engine.execute_model(batch)
        HISTOGRAMS.observe("execute_model_latency_seconds", time.monotonic() - t0)
        self._process_outputs(batch)

    def _resolve_inflight(self) -> int:
        """Fetch the in-flight step's outputs and deliver them."""
        if self._inflight is None:
            return 0
        batch, outs = self._inflight
        self._inflight = None
        t0 = time.monotonic()
        self._engine.finalize_model(batch, outs)
        HISTOGRAMS.observe("execute_model_latency_seconds", time.monotonic() - t0)
        self._process_outputs(batch)
        return len(batch.entries)

    def run_until_complete(self) -> None:
        """Loop until all scheduled work is done, the in-flight step
        included."""
        while True:
            stepped = self.step(timeout_s=0.0)
            if (stepped == 0 and self._inflight is None and self.num_pending_requests == 0
                    and not self._requests):
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
            if self._swapper is not None:
                self._swapper.discard(seq)
        self._response_handler.on_request_finish(request)
        with self._pending_lock:
            self._pending -= 1
        HISTOGRAMS.observe(
            "end_2_end_latency_seconds", time.monotonic() - request.created_time
        )
        COUNTERS.inc("responsing_rounds" if request.stream else "non_stream_responses")

    def _build_batch(self, timeout_s: float, pipelined: bool = False) -> Batch:
        """pipelined=True builds the next step while one is in flight: no
        preemption (an in-flight victim's pages are still being written), no
        n/best_of expansion (the parent's last token is unresolved), and
        sequences whose pending token already reaches a length limit are
        left for the resolve."""
        t0 = time.monotonic()
        self._starved = False
        self._drain_intake(timeout_s)
        if self._swapper is not None:
            # The host copies of the last preemptions' pages ran behind the
            # step enqueued after them.
            self._swapper.finalize_staging()
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
                if pipelined:
                    # the parent's sample is in flight: expand after the
                    # pipeline drains (this request sits out one build)
                    self._starved = True
                    continue
                req.expand_sequences()

        batch = Batch()
        token_budget = opts.max_tokens_per_batch
        seq_budget = opts.max_seqs_per_batch
        # Decode sequences reserve KV slots for a speculative round's
        # proposals and for the micro-steps of a multi-step dispatch.
        spec_overhead = max(opts.num_speculative_tokens, self._multi_n - 1)
        for req in self._requests:
            if token_budget <= 0 or seq_budget <= 0:
                break
            for seq in req.sequences:
                if token_budget <= 0 or seq_budget <= 0:
                    break
                if seq.is_finished():
                    continue
                if pipelined and seq.has_pending and seq.would_finish_by_length():
                    # the in-flight token already reaches max_tokens or the
                    # context: a step for it would be discarded
                    continue
                if self._swapper is not None and not seq.blocks and self._swapper.has_entry(seq):
                    # Preempted with staged pages: restore them rather than
                    # re-prefill. Where the blocks cannot be allocated the
                    # entry stays and the sequence waits for a later build.
                    if not self._swapper.swap_in(seq):
                        continue
                cached = seq.num_kv_cache_tokens()
                uncached = seq.num_tokens - cached
                if uncached <= 0:
                    continue
                # Chunked prefill: clamp to the remaining token budget.
                n = min(uncached, token_budget)
                extra = spec_overhead if uncached == 1 else 0
                target = cached + n + extra
                if pipelined:
                    # No preemption while a step is in flight; a starved
                    # sequence makes the next step run synchronously.
                    if not self._block_manager.allocate_blocks_for(seq, target):
                        self._starved = True
                        continue
                elif not self._allocate_with_preemption(req, seq, target, batch):
                    continue  # out of memory even after preemption: wait
                # A prefix-cache hit during allocation may have served part
                # of the prompt from shared blocks — recompute the chunk, and
                # top up blocks if it now reaches further than the target.
                cached = seq.num_kv_cache_tokens()
                n = min(seq.num_tokens - cached, token_budget)
                if n <= 0:
                    continue
                if cached + n + extra > target and not self._block_manager.allocate_blocks_for(
                    seq, cached + n + extra
                ):
                    n = seq.kv_cache_capacity - extra - cached  # what the blocks cover
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
        # request already in this step's batch. At equal priority a victim
        # whose pages fit the host pool's free space goes first: staging it
        # evicts no earlier victim's pages (which would turn that swap-in
        # back into a recompute).
        in_batch = {id(e.seq) for e in batch.entries}

        def victim_key(r):
            fits = 0
            if self._swapper is not None:
                fits = int(all(self._swapper.staging_fits(s) for s in r.sequences if s.blocks))
            return (int(r.priority), fits, r.arrival_seq)

        for victim in sorted(self._requests, key=victim_key, reverse=True):
            if victim is req:
                continue
            if any(id(s) in in_batch for s in victim.sequences):
                continue
            if not any(s.blocks for s in victim.sequences):
                continue
            self._preempt(victim)
            COUNTERS.inc("num_preempted_requests")
            if self._block_manager.allocate_blocks_for(seq, num_tokens):
                return True
        return self._block_manager.allocate_blocks_for(seq, num_tokens)

    def _preempt(self, request: Request) -> None:
        """Release all KV of the request. With a KV swapper its pages are
        staged in host memory first (restored when it is scheduled again);
        otherwise it re-prefills later (the prefix cache may hold most of
        it)."""
        for seq in request.sequences:
            if self._swapper is not None and self._swapper.swap_out(seq):
                # The staged pages stand in for a prefix-cache copy: the
                # blocks are not published, so the swap-in lands in
                # unshared blocks.
                self._block_manager.release_without_caching(seq)
                continue
            self._block_manager.deallocate(seq)

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
                # A request finished at the previous resolve may still own a
                # (discarded) row in this async step: it was retired then.
                if req in self._requests:
                    self._requests.remove(req)
                    self._finish_request(req)
            elif req.stream:
                self._response_handler.on_request_stream(req)
