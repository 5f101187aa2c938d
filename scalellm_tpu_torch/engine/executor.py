"""Executor — runs the per-step model program
(counterpart of scalellm_tpu/engine/executor.py, single device).

One step is forward -> logits -> sample_tokens, run under
torch.inference_mode. The paged KV cache is one persistent tensor
(model.kv_cache_shape: [L, P, page, 2*Hkv, Dh], or [L, P, page, 1, Dc] for
MLA's latent cache) that every step updates IN PLACE.

The reference compiles one XLA program per padded (T, S, MAXP) bucket and
replays it (its _step_fn_for and jit cache; warmup compiles the serving
buckets ahead). Here, with graphs on (init_graphs), forward + logits of a
bucket are captured once into a CUDA graph (StepGraphs) and replayed on
every later step of that bucket; the sampler runs eagerly after the
replay, on the graph's logits. With graphs off the step runs eagerly.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scalellm_tpu_torch.engine.batch import PAGE_BUCKETS, SEQ_BUCKETS, TOKEN_BUCKETS, pick_bucket
from scalellm_tpu_torch.engine.params import (
    ModelInputs, ModelOutputs, SamplingInputs, StepInputs, step_words,
)
from scalellm_tpu_torch.sampling.sampler import SamplingPlan, sample_tokens
from scalellm_tpu_torch.utils.metrics import COUNTERS

logger = logging.getLogger(__name__)

WARMUP_MODES = ("off", "fast", "full")

Bucket = Tuple[int, int, int, bool]  # (T, S, MAXP, decode_only)


def warmup_buckets(block_size: int, mode: str, max_tokens: int, max_seqs: int,
                   max_context_len: int) -> List[Bucket]:
    """The (T, S, MAXP, decode_only) buckets the reference's warmup runs
    (scalellm_tpu/engine/executor.py:warmup), in its order. "fast": the two
    cheapest decode buckets; "full": every bucket reachable under the
    serving envelope, the decode ladder (T tracks S) and the mixed steps at
    the token budget, over the page buckets up to max_context_len."""
    if mode not in WARMUP_MODES:
        raise ValueError(f"warmup_mode must be one of {WARMUP_MODES}, got {mode!r}")
    if mode == "off":
        return []
    if mode == "fast":
        return [(16, 1, PAGE_BUCKETS[0], True), (16, 8, PAGE_BUCKETS[0], True)]
    pages_env = pick_bucket(PAGE_BUCKETS, max(max_context_len // block_size, 1))
    maxps = [b for b in PAGE_BUCKETS if b <= pages_env]
    s_env = pick_bucket(SEQ_BUCKETS, max(max_seqs, 1))
    t_pre = pick_bucket(TOKEN_BUCKETS, min(max_tokens, TOKEN_BUCKETS[-1]))
    buckets = set()
    for S in SEQ_BUCKETS:
        if S > s_env:
            break
        for mp in maxps:
            buckets.add((pick_bucket(TOKEN_BUCKETS, S), S, mp, True))
            buckets.add((t_pre, S, mp, False))
    return sorted(buckets)


def envelope_words(block_size: int, max_tokens: int, max_seqs: int, max_context_len: int) -> int:
    """int32 words of the largest bucket a step can have under the serving
    envelope: the token budget (and the decode ladder's T at the sequence
    budget), the sequence budget, and the pages of max_context_len."""
    S = pick_bucket(SEQ_BUCKETS, min(max(max_seqs, 1), SEQ_BUCKETS[-1]))
    T = pick_bucket(TOKEN_BUCKETS, min(max(max_tokens, S, 1), TOKEN_BUCKETS[-1]))
    P = pick_bucket(PAGE_BUCKETS, min(max(-(-max_context_len // block_size), 1), PAGE_BUCKETS[-1]))
    return step_words(T, S, P)


def minimal_inputs(T: int, S: int, MAXP: int) -> ModelInputs:
    """The reference's warmup batch for a bucket: one sequence of one token
    with its KV on the reserved page 0 (not all zeros: a kernel must see a
    valid batch). Shapes alone decide what is captured."""
    kv_lens = np.zeros(S, np.int32)
    kv_lens[0] = 1
    cu_q_lens = np.ones(S + 1, np.int32)
    cu_q_lens[0] = 0
    return ModelInputs(
        token_ids=np.zeros(T, np.int32), positions=np.zeros(T, np.int32),
        token_seg=np.zeros(T, np.int32), new_kv_slot_ids=np.zeros(T, np.int32),
        block_tables=np.zeros((S, MAXP), np.int32), kv_lens=kv_lens, cu_q_lens=cu_q_lens,
        num_seqs=np.ones(1, np.int32), selected_idxes=np.zeros(S, np.int32),
        seq_mask=np.zeros(S, np.float32),
    )


@dataclass
class _Captured:
    inputs: ModelInputs  # views of the step buffer
    decode_only: bool
    graph: Optional["torch.cuda.CUDAGraph"] = None
    logits: Optional[torch.Tensor] = None  # the graph's static output [S, V]


class StepGraphs:
    """forward + logits captured once per bucket key and replayed: the
    port's counterpart of the reference's jit bucket cache.

    A key is (T, S, MAXP, decode_only), where decode_only is kept only for a
    model with a decode kernel of its own (`model.mla`); dense models share
    one program for decode-only and mixed steps, as the reference's
    _step_fn_for does. Every key reads views of one StepInputs buffer, which
    each step rewrites whole, padding included.

    On a CUDA device a key is captured (after one eager run on a side
    stream, which does the kernels' one-time setup outside the capture)
    into a CUDA graph in a memory pool that all keys share, and replayed;
    a capture or replay that fails raises. On the CPU the same keys,
    buffer and counters are kept, and a replay runs the step function on
    the buffer's views. A capture outside warmup is the reference's
    mid-serve compile: COUNTERS num_mid_serve_compiles counts it."""

    def __init__(self, forward, device, words: int, mla: bool):
        self._forward = forward  # (ModelInputs, decode_only) -> logits
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.mla = mla
        self.inputs = StepInputs(words, self.device)
        self.graphs: Dict[Bucket, _Captured] = {}
        self.replays: Counter = Counter()
        self.capture_s = 0.0
        self.in_warmup = False
        self.last_key: Optional[Bucket] = None
        if self.cuda:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)

    def key(self, T: int, S: int, MAXP: int, decode_only: bool) -> Bucket:
        return (T, S, MAXP, bool(decode_only and self.mla))

    def run(self, mi: ModelInputs, decode_only: bool) -> torch.Tensor:
        """One step of the padded host arrays `mi`: fill the buffer, capture
        the bucket's key if it is new, replay it. Returns the static logits
        [S, V], valid until the next run."""
        T, (S, MAXP) = mi.token_ids.shape[0], mi.block_tables.shape
        key = self.key(T, S, MAXP, decode_only)
        self.inputs.fill(mi)
        step = self.graphs.get(key)
        if step is None:
            step = self._capture(key)
        self._replay(step)
        self.replays[key] += 1
        self.last_key = key
        return step.logits

    def _capture(self, key: Bucket) -> _Captured:
        t0 = time.monotonic()
        T, S, MAXP, decode_only = key
        step = _Captured(self.inputs.views(T, S, MAXP), decode_only)
        if self.cuda:
            self._side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._side):
                self._forward(step.inputs, decode_only)
            torch.cuda.current_stream(self.device).wait_stream(self._side)
            self.record(step)
        self.graphs[key] = step
        self.capture_s += time.monotonic() - t0
        if not self.in_warmup:
            COUNTERS.inc("num_mid_serve_compiles")
            logger.info("mid-serve capture: bucket T=%d S=%d MAXP=%d decode_only=%s", *key)
        return step

    def record(self, step: _Captured) -> None:
        """Capture the step's forward + logits into a CUDA graph (nothing
        runs on the device)."""
        step.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(step.graph, pool=self._pool):
            step.logits = self._forward(step.inputs, step.decode_only)

    def _replay(self, step: _Captured) -> None:
        if self.cuda:
            step.graph.replay()
        else:
            step.logits = self._forward(step.inputs, step.decode_only)

    def pool_bytes(self) -> int:
        """Device bytes the graphs' shared memory pool holds (0 on the CPU)."""
        if not self.cuda:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))


class Executor:
    """Owns the model (weights on the device), the KV cache and, with graphs
    on, the captured step programs."""

    def __init__(self, model, device, max_top_logprobs: int = 0):
        self.model = model
        self.device = torch.device(device)
        self.max_top_logprobs = max_top_logprobs
        self.kv_cache = None
        self.graphs: Optional[StepGraphs] = None

    def init_kv_cache(self, num_blocks: int, block_size: int) -> None:
        """Allocate the paged KV cache."""
        self.kv_cache = torch.zeros(
            self.model.kv_cache_shape(num_blocks, block_size),
            dtype=self.model.dtype, device=self.device,
        )

    def kv_cache_bytes(self, num_blocks: int, block_size: int) -> int:
        n = 1
        for d in self.model.kv_cache_shape(num_blocks, block_size):
            n *= d
        return n * self.model.dtype.itemsize

    def init_graphs(self, block_size: int, max_tokens: int, max_seqs: int, max_context_len: int) -> None:
        """Serve every later step through StepGraphs, with the step buffer
        sized for the serving envelope."""
        self.graphs = StepGraphs(
            self._forward, self.device, envelope_words(block_size, max_tokens, max_seqs, max_context_len),
            mla=getattr(self.model, "mla", False))

    def _forward(self, mi: ModelInputs, decode_only: bool) -> torch.Tensor:
        hidden = self.model(self.kv_cache, mi, decode_only=decode_only)
        return self.model.logits(hidden)

    @torch.inference_mode()
    def execute(self, mi: ModelInputs, si: SamplingInputs, decode_only: bool = False) -> ModelOutputs:
        """Run one step of the batch's padded host arrays; the KV cache is
        updated in place. Outputs stay on the device. decode_only: every
        sequence has one token (MLA models take their decode kernel on such
        a step)."""
        if self.kv_cache is None:
            raise RuntimeError("init_kv_cache first")
        if self.graphs is not None:
            logits = self.graphs.run(mi, decode_only)
        else:
            logits = self._forward(mi.to(self.device), decode_only)
        plan = SamplingPlan.of(si)
        if plan.reads_inputs:
            si = si.to(self.device)
        return sample_tokens(logits, si, max_top_logprobs=self.max_top_logprobs, plan=plan)

    @torch.inference_mode()
    def warmup(self, block_size: int, mode: str = "fast", max_tokens: int = 512, max_seqs: int = 128,
               max_context_len: int = 4096) -> None:
        """Capture the reference's warmup buckets (warmup_buckets), largest
        first, each from its minimal batch: the counterpart of the
        reference's compile at init. Needs init_graphs."""
        buckets = warmup_buckets(block_size, mode, max_tokens, max_seqs, max_context_len)
        if not buckets:
            return
        if self.graphs is None:
            raise RuntimeError("warmup captures step graphs: init_graphs first")
        t0 = time.monotonic()
        self.graphs.in_warmup = True
        try:
            for T, S, MAXP, decode_only in sorted(buckets, reverse=True):
                if self.graphs.key(T, S, MAXP, decode_only) not in self.graphs.graphs:
                    self.graphs.run(minimal_inputs(T, S, MAXP), decode_only)
        finally:
            self.graphs.in_warmup = False
        logger.info("warmed %d buckets (%s) into %d graphs in %.1fs", len(buckets), mode,
                    len(self.graphs.graphs), time.monotonic() - t0)
