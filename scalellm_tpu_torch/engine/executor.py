"""Executor — runs the per-step model program
(counterpart of scalellm_tpu/engine/executor.py, single device).

One step is forward -> logits -> sample_tokens, run under
torch.inference_mode. The paged KV cache is one persistent tensor
(model.kv_cache_shape: [L, P, page, 2*Hkv, Dh], or [L, P, page, 1, Dc] for
MLA's latent cache; int8 for a model with kv_quant, else the model's dtype)
that every step updates IN PLACE.

KV swap (memory/kv_swap.py) moves whole pages across it: fetch_pages_async
gathers pages on the device and starts their copy to pinned host memory
behind an event (a PendingFetch), fetch_pages waits for it, and
restore_pages writes staged pages back into other pages of the same tensor,
in place: the step graphs captured its address.

The reference compiles one XLA program per padded (T, S, MAXP) bucket and
replays it (its _step_fn_for and jit cache; warmup compiles the serving
buckets ahead). Here, with graphs on (init_graphs), forward + logits of a
bucket are captured once into a CUDA graph (StepGraphs) and replayed on
every later step of that bucket; the sampler runs eagerly after the
replay, on the graph's logits. With graphs off the step runs eagerly.

Multi-step decode (execute_multi, the reference's _build_multi_step_fn):
one dispatch runs N decode micro-steps, each recomputing positions, KV
lengths and KV slots on the device and feeding its sampled tokens to the
next; with graphs on, the N micro-steps, sampler included, are ONE CUDA
graph per (N, T, S, MAXP, sampling plan). Async stepping merges a step's
pending tokens (the previous step's samples, still on the device) into its
token ids before the forward (merge_pending_tokens). Every step's outputs
are copied to pinned host memory right after its sampler (HostOutputs), and
a fetch waits for that copy alone, not for later steps on the stream.

A speculative round (speculative/spec_executor.py: k draft steps, the
target's verify forward and the rejection sampler) is one more kind of key
in the same StepGraphs (run_round): its inputs are one flat int32 buffer of
its own, its graph lives in the shared pool.

Prompt scoring (execute_score, the reference's _build_score_step_fn) is an
eager step: the forward keeps every row's hidden state, the sampler runs on
the selected rows, and the lm_head, an f32 log_softmax, the target's
logprob and the top-k run over the rows in chunks of 128.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from scalellm_tpu_torch.engine.batch import PAGE_BUCKETS, SEQ_BUCKETS, TOKEN_BUCKETS, pick_bucket
from scalellm_tpu_torch.engine.params import (
    ModelInputs, ModelOutputs, SamplingInputs, StepInputs, step_words,
)
from scalellm_tpu_torch.sampling.sampler import SamplingPlan, sample_tokens, step_seeds
from scalellm_tpu_torch.utils.metrics import COUNTERS

logger = logging.getLogger(__name__)

WARMUP_MODES = ("off", "fast", "full")

Bucket = Tuple[int, int, int, bool]  # (T, S, MAXP, decode_only)
# A multi-step graph's key: (T, S, MAXP, True, N, page_size, SamplingPlan).
MultiKey = Tuple[int, int, int, bool, int, int, SamplingPlan]


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
    valid batch), every LoRA slot the base's. Shapes alone decide what is
    captured."""
    kv_lens = np.zeros(S, np.int32)
    kv_lens[0] = 1
    cu_q_lens = np.ones(S + 1, np.int32)
    cu_q_lens[0] = 0
    return ModelInputs(
        token_ids=np.zeros(T, np.int32), positions=np.zeros(T, np.int32),
        token_seg=np.zeros(T, np.int32), new_kv_slot_ids=np.zeros(T, np.int32),
        block_tables=np.zeros((S, MAXP), np.int32), kv_lens=kv_lens, cu_q_lens=cu_q_lens,
        num_seqs=np.ones(1, np.int32), selected_idxes=np.zeros(S, np.int32),
        seq_mask=np.zeros(S, np.float32), lora_ids=np.zeros(S, np.int32),
    )


def minimal_sampling_inputs(S: int) -> SamplingInputs:
    """The reference's warmup sampling inputs: every row greedy, no stage."""
    return SamplingInputs(
        temperatures=np.zeros(S, np.float32), top_ks=np.zeros(S, np.int32), top_ps=np.ones(S, np.float32),
        frequency_penalties=np.zeros(S, np.float32), presence_penalties=np.zeros(S, np.float32),
        repetition_penalties=np.ones(S, np.float32), unique_token_ids=np.zeros((S, 1), np.int32),
        unique_token_counts=np.zeros((S, 1), np.int32), bias_token_ids=np.zeros((S, 1), np.int32),
        bias_values=np.zeros((S, 1), np.float32), allowed_mask=np.full((S, 1), 0xFFFFFFFF, np.uint32),
        seeds=np.zeros(S, np.uint32),
    )


def merge_pending_tokens(token_ids: torch.Tensor, prev_next_tokens: torch.Tensor, gather: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Device-side token feedback of async stepping (the reference's
    _merge_pending_tokens): rows with a nonzero mask take the previous
    step's sampled token at row gather[t]; the others keep their id."""
    prev = prev_next_tokens.to(token_ids.dtype)[gather.long()]
    return torch.where(mask != 0, prev, token_ids)


def check_multi_step_plan(plan: SamplingPlan) -> None:
    """A multi-step dispatch feeds its samples back on the device, so no
    stage may need host feedback between micro-steps: penalties read token
    histograms and the allowed mask a guided state, both rebuilt on the
    host every token. The scheduler sends such batches single-step
    (Batch.can_multi_step), as the reference does."""
    if plan.penalties or plan.repetition or plan.allowed_mask:
        raise ValueError("a multi-step dispatch cannot run penalties or an allowed mask "
                         "(Batch.can_multi_step sends such batches single-step)")


class HostOutputs:
    """A step's outputs, and their copy to host memory, enqueued right after
    the step's sampler: `outs` stays on the device (the next step's pending
    merge reads outs.next_tokens), `wait` returns numpy arrays once that
    copy alone is done (an event recorded after it; pinned memory on a CUDA
    device), whatever was enqueued after it. Logprobs are copied only when
    `logprobs` is set."""

    NAMES = ("next_tokens", "logprobs", "top_ids", "top_logprobs")

    def __init__(self, outs: ModelOutputs, logprobs: bool):
        self.outs = outs
        cuda = outs.next_tokens.is_cuda
        names = self.NAMES if logprobs else self.NAMES[:1]
        self._host = {n: getattr(outs, n).to("cpu", non_blocking=cuda) for n in names}
        self._copied = None
        if cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()

    def wait(self) -> Dict[str, Optional[np.ndarray]]:
        """The outputs as numpy arrays (None for those not copied)."""
        if self._copied is not None:
            self._copied.synchronize()
        return {n: self._host[n].numpy() if n in self._host else None for n in self.NAMES}


@dataclass
class _Captured:
    inputs: ModelInputs  # views of the step buffer (a round: its own flat int32 buffer)
    decode_only: bool
    graph: Optional["torch.cuda.CUDAGraph"] = None
    logits: Optional[torch.Tensor] = None  # the graph's static output ([S, V]; ModelOutputs [N, ...] for N steps)
    fn: Optional[Callable] = None  # what the graph runs, on the step's static inputs
    bias: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # an N-step graph's static bias ids/values
    staging: Optional[torch.Tensor] = None  # a round's host staging buffer (pinned on a CUDA device)
    sent: Optional["torch.cuda.Event"] = None  # the last copy out of `staging`


class StepGraphs:
    """forward + logits captured once per bucket key and replayed: the
    port's counterpart of the reference's jit bucket cache.

    A key is (T, S, MAXP, decode_only), where decode_only is kept only for a
    model with a decode kernel of its own (`model.mla`); dense models share
    one program for decode-only and mixed steps, as the reference's
    _step_fn_for does. A multi-step graph (run_multi) holds N decode
    micro-steps, the sampler included, under the key (T, S, MAXP, True, N,
    page_size, plan): the plan's stages are baked into the graph. Every such
    key reads views of one StepInputs buffer, which each step rewrites
    whole, padding included. A speculative round (run_round) has a key whose
    first entry is its kind ("draft_round", "ngram_round") and reads a
    buffer of its own.

    On a CUDA device a key is captured (after one eager run on a side
    stream, which does the kernels' one-time setup outside the capture)
    into a CUDA graph in a memory pool that all keys share, and replayed;
    a capture or replay that fails raises. On the CPU the same keys,
    buffer and counters are kept, and a replay runs the step function on
    the buffer's views. A capture outside warmup is the reference's
    mid-serve compile: COUNTERS num_mid_serve_compiles counts it."""

    def __init__(self, forward, device, words: int, mla: bool, multi=None):
        self._forward = forward  # (ModelInputs, decode_only) -> logits
        self._multi = multi  # (ModelInputs, SamplingInputs, plan, N, page_size) -> ModelOutputs [N, ...]
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.mla = mla
        self.inputs = StepInputs(words, self.device)
        self.graphs: Dict[tuple, _Captured] = {}
        self.replays: Counter = Counter()
        self.capture_s = 0.0
        self.in_warmup = False
        self.last_key: Optional[tuple] = None
        if self.cuda:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)

    def key(self, T: int, S: int, MAXP: int, decode_only: bool) -> Bucket:
        return (T, S, MAXP, bool(decode_only and self.mla))

    def multi_key(self, T: int, S: int, MAXP: int, N: int, page_size: int, plan: SamplingPlan) -> MultiKey:
        return (T, S, MAXP, True, N, page_size, plan)

    def run(self, mi: ModelInputs, decode_only: bool, pending=None) -> torch.Tensor:
        """One step of the padded host arrays `mi`: fill the buffer, merge
        the pending tokens (pending: (mask [T], gather [T], the previous
        step's next_tokens on the device) or None), capture the bucket's key
        if it is new, replay it. Returns the static logits [S, V], valid
        until the next run."""
        T, (S, MAXP) = mi.token_ids.shape[0], mi.block_tables.shape
        key = self.key(T, S, MAXP, decode_only)
        self.inputs.fill(mi, pending=pending[:2] if pending is not None else None)
        if pending is not None:
            tok = self.inputs.views(T, S, MAXP).token_ids
            extra = self.inputs.extra_views(T, S, MAXP)
            tok.copy_(merge_pending_tokens(tok, pending[2], extra["pending_gather"], extra["pending_mask"]))
        step = self.graphs.get(key)
        if step is None:
            views = self.inputs.views(T, S, MAXP)
            step = self._capture(key, _Captured(
                views, key[3], fn=lambda: self._forward(views, key[3])))
        self._replay(step)
        self.replays[key] += 1
        self.last_key = key
        return step.logits

    def run_multi(self, mi: ModelInputs, si: SamplingInputs, plan: SamplingPlan, N: int,
                  page_size: int) -> ModelOutputs:
        """N decode micro-steps of the padded host arrays (mi, si) through
        one graph of key (T, S, MAXP, True, N, page_size, plan). Returns the
        static ModelOutputs [N, ...], valid until the next run."""
        check_multi_step_plan(plan)
        T, (S, MAXP) = mi.token_ids.shape[0], mi.block_tables.shape
        key = self.multi_key(T, S, MAXP, N, page_size, plan)
        self.inputs.fill(mi, si)
        step = self.graphs.get(key)
        if step is None:
            views = self.inputs.views(T, S, MAXP)
            extra = self.inputs.extra_views(T, S, MAXP)
            bias = None
            if plan.bias:
                bias = (torch.zeros((S, plan.bias_width), dtype=torch.int32, device=self.device),
                        torch.zeros((S, plan.bias_width), dtype=torch.float32, device=self.device))
            sv = SamplingInputs(
                temperatures=extra["temperatures"], top_ks=extra["top_ks"], top_ps=extra["top_ps"],
                frequency_penalties=None, presence_penalties=None, repetition_penalties=None,
                unique_token_ids=None, unique_token_counts=None,
                bias_token_ids=bias[0] if bias else None, bias_values=bias[1] if bias else None,
                allowed_mask=None, seeds=extra["seeds"])
            step = _Captured(views, True, bias=bias,
                             fn=lambda: self._multi(views, sv, plan, N, page_size))
            self._copy_bias(step, si)
            step = self._capture(key, step)
        else:
            self._copy_bias(step, si)
        self._replay(step)
        self.replays[key] += 1
        self.last_key = key
        return step.logits

    def run_round(self, key: tuple, words: np.ndarray, fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """One speculative round: `words`, the round's padded host inputs as
        one flat int32 array, go with one copy to the key's own device
        buffer (allocated at the key's capture and never reallocated), and
        fn(buffer), the round on the device, is captured once for the key
        and replayed. Returns the round's static output, valid until the
        key's next run."""
        step = self.graphs.get(key)
        if step is None:
            buf = torch.zeros(words.size, dtype=torch.int32, device=self.device)
            step = _Captured(buf, True, fn=lambda: fn(buf),
                             staging=torch.zeros(words.size, dtype=torch.int32, pin_memory=self.cuda),
                             sent=torch.cuda.Event() if self.cuda else None)
            self._send(step, words)
            step = self._capture(key, step)
        else:
            self._send(step, words)
        self._replay(step)
        self.replays[key] += 1
        self.last_key = key
        return step.logits

    @staticmethod
    def _send(step: _Captured, words: np.ndarray) -> None:
        """Write a round's inputs through its staging buffer, once the
        staging buffer's last copy is done."""
        if words.size != step.inputs.numel():
            raise ValueError(f"{words.size} words for a round buffer of {step.inputs.numel()}")
        if step.sent is not None:
            step.sent.synchronize()
        step.staging.numpy()[:] = words
        step.inputs.copy_(step.staging, non_blocking=True)
        if step.sent is not None:
            step.sent.record()

    def _copy_bias(self, step: _Captured, si: SamplingInputs) -> None:
        if step.bias is not None:
            step.bias[0].copy_(torch.from_numpy(np.asarray(si.bias_token_ids, np.int32)), non_blocking=True)
            step.bias[1].copy_(torch.from_numpy(np.asarray(si.bias_values, np.float32)), non_blocking=True)

    def _capture(self, key: tuple, step: _Captured) -> _Captured:
        t0 = time.monotonic()
        if self.cuda:
            self._side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._side):
                step.fn()
            torch.cuda.current_stream(self.device).wait_stream(self._side)
            self.record(step)
        self.graphs[key] = step
        self.capture_s += time.monotonic() - t0
        if not self.in_warmup:
            COUNTERS.inc("num_mid_serve_compiles")
            if isinstance(key[0], str):
                logger.info("mid-serve capture: %s S=%d MAXP=%d k=%d", *key[:4])
            else:
                logger.info("mid-serve capture: bucket T=%d S=%d MAXP=%d decode_only=%s%s", *key[:4],
                            f" steps={key[4]}" if len(key) > 4 else "")
        return step

    def record(self, step: _Captured) -> None:
        """Capture the step's function (forward + logits, or N micro-steps
        with their sampler) into a CUDA graph (nothing runs on the
        device). Python's cyclic garbage collector stays off while the
        stream captures: a collection there that drops another engine's
        graphs destroys them, which a capturing stream does not permit (the
        capture is invalidated); torch.cuda.graph collects before it
        begins."""
        step.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(step.graph, pool=self._pool):
                step.logits = step.fn()
        finally:
            if collecting:
                gc.enable()

    def _replay(self, step: _Captured) -> None:
        if self.cuda:
            step.graph.replay()
        else:
            step.logits = step.fn()

    def pool_bytes(self) -> int:
        """Device bytes the graphs' shared memory pool holds (0 on the CPU)."""
        if not self.cuda:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))


class PendingFetch:
    """Pages gathered on the device and on their way to host memory: the
    gathered copy (kept alive until the host copy is done), the host tensor
    (pinned on a CUDA device) and the event recorded after the copy. `wait`
    returns the host tensor once the copy is done."""

    def __init__(self, gathered: torch.Tensor):
        self._gathered = gathered
        self._done = None
        if gathered.is_cuda:
            self.host = torch.empty(gathered.shape, dtype=gathered.dtype, pin_memory=True)
            self.host.copy_(gathered, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self.host = gathered

    @property
    def nbytes(self) -> int:
        return self.host.numel() * self.host.element_size()

    def wait(self) -> torch.Tensor:
        if self._done is not None:
            self._done.synchronize()
            self._done = None
        self._gathered = None
        return self.host


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
            dtype=self.model.kv_cache_dtype(), device=self.device,
        )

    def kv_cache_bytes(self, num_blocks: int, block_size: int) -> int:
        n = 1
        for d in self.model.kv_cache_shape(num_blocks, block_size):
            n *= d
        return n * self.model.kv_cache_dtype().itemsize

    # ------------------------------------------------------------ kv swap

    def fetch_pages_async(self, page_ids: np.ndarray) -> PendingFetch:
        """Start the copy of the given KV pages ([L, n, page, ...], pages on
        dim 1) to host memory: a gather on the device on the current stream,
        then a copy to pinned host memory behind an event; returns without
        waiting. A step enqueued after it may overwrite the pages: the
        stream runs the gather first."""
        ids = torch.as_tensor(np.asarray(page_ids, np.int64)).to(self.device, non_blocking=True)
        return PendingFetch(self.kv_cache.index_select(1, ids))

    def fetch_pages(self, page_ids: np.ndarray) -> torch.Tensor:
        """The given KV pages in host memory, [L, n, page, ...]."""
        return self.fetch_pages_async(page_ids).wait()

    def restore_pages(self, page_ids: np.ndarray, data: torch.Tensor) -> None:
        """Write staged pages (host [L, n, page, ...]) into pages `page_ids`
        of the KV cache, in place (index_copy_ on the current stream): the
        cache keeps its address, which the captured step graphs read."""
        if data.shape[1] != len(page_ids):
            raise ValueError(f"{data.shape[1]} staged pages for {len(page_ids)} page ids")
        ids = torch.as_tensor(np.asarray(page_ids, np.int64)).to(self.device, non_blocking=True)
        self.kv_cache.index_copy_(1, ids, data.to(self.device, non_blocking=True))

    def init_graphs(self, block_size: int, max_tokens: int, max_seqs: int, max_context_len: int) -> None:
        """Serve every later step through StepGraphs, with the step buffer
        sized for the serving envelope."""
        self.graphs = StepGraphs(
            self._forward, self.device, envelope_words(block_size, max_tokens, max_seqs, max_context_len),
            mla=getattr(self.model, "mla", False), multi=self._multi_steps)

    def _forward(self, mi: ModelInputs, decode_only: bool) -> torch.Tensor:
        hidden = self.model(self.kv_cache, mi, decode_only=decode_only)
        return self.model.logits(hidden)

    def _multi_steps(self, mi: ModelInputs, si: SamplingInputs, plan: SamplingPlan, N: int,
                     page_size: int) -> ModelOutputs:
        """N decode micro-steps on the device (the reference's
        _build_multi_step_fn): micro-step i runs at positions + i and
        kv_lens + i, each token's KV slot recomputed from the block table
        (a window may cross a page), then forward, logits and the sampler
        with the seeds folded for step i; its samples are the next step's
        tokens. Bucket-padding rows (past cu_q_lens[num_seqs]) write their
        KV to the reserved page 0; a position past a sequence's pages takes
        the block table's last column, zero padding where the sequence
        holds fewer pages, so page 0 again. Reads nothing back to the host.
        Returns ModelOutputs whose fields have a leading [N] dim."""
        T, MAXP = mi.token_ids.shape[0], mi.block_tables.shape[1]
        rows = torch.arange(T, dtype=torch.int32, device=mi.token_ids.device)
        valid = rows < mi.cu_q_lens.index_select(0, mi.num_seqs.long())
        seg = mi.token_seg.long()
        tokens = mi.token_ids
        outs = []
        for i in range(N):
            pos = mi.positions + i
            page = torch.clamp(pos // page_size, max=MAXP - 1).long()
            blocks = mi.block_tables[seg, page]
            slots = torch.where(valid, blocks * page_size + pos % page_size, torch.zeros_like(blocks))
            mi_i = dataclasses.replace(mi, token_ids=tokens, positions=pos, new_kv_slot_ids=slots,
                                       kv_lens=mi.kv_lens + i)
            logits = self._forward(mi_i, True)
            si_i = dataclasses.replace(si, seeds=step_seeds(si.seeds, i)) if plan.temperature else si
            out = sample_tokens(logits, si_i, max_top_logprobs=self.max_top_logprobs, plan=plan)
            tokens = out.next_tokens[seg].to(mi.token_ids.dtype)
            outs.append(out)
        return ModelOutputs(*(torch.stack([getattr(o, f.name) for o in outs])
                              for f in dataclasses.fields(ModelOutputs)))

    @torch.inference_mode()
    def execute(self, mi: ModelInputs, si: SamplingInputs, decode_only: bool = False,
                pending=None) -> ModelOutputs:
        """Run one step of the batch's padded host arrays; the KV cache is
        updated in place. Outputs stay on the device. decode_only: every
        sequence has one token (MLA models take their decode kernel on such
        a step). pending: (mask [T] bool, gather [T] int32, the previous
        step's next_tokens on the device): async stepping's rows whose token
        is that step's sample, merged on the device before the forward."""
        if self.kv_cache is None:
            raise RuntimeError("init_kv_cache first")
        if self.graphs is not None:
            logits = self.graphs.run(mi, decode_only, pending)
        else:
            mi = mi.to(self.device)
            if pending is not None:
                mask, gather, prev = pending
                mi.token_ids = merge_pending_tokens(
                    mi.token_ids, prev, torch.from_numpy(np.asarray(gather)).to(self.device),
                    torch.from_numpy(np.asarray(mask)).to(self.device))
            logits = self._forward(mi, decode_only)
        plan = SamplingPlan.of(si)
        if plan.reads_inputs:
            si = si.to(self.device)
        return sample_tokens(logits, si, max_top_logprobs=self.max_top_logprobs, plan=plan)

    @torch.inference_mode()
    def execute_score(self, mi: ModelInputs, si: SamplingInputs, targets: np.ndarray,
                      top_k: int) -> Tuple[ModelOutputs, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """One step that also scores the prompt (the reference's score step,
        eager): the forward keeps the hidden states of all T rows, the
        sampler runs on the selected rows as execute does, and for every row
        t the f32 log_softmax of its logits gives the logprob of targets[t]
        and the top_k alternatives; the lm_head runs over chunks of 128 rows
        (T when T is no multiple of 128), so that [T, V] logits never exist
        at once. Returns (ModelOutputs, (target logprobs [T], top ids [T,
        top_k], top logprobs [T, top_k])), on the device."""
        if self.kv_cache is None:
            raise RuntimeError("init_kv_cache first")
        mi = mi.to(self.device)
        h = self.model(self.kv_cache, mi, all_hidden=True)
        plan = SamplingPlan.of(si)
        if plan.reads_inputs:
            si = si.to(self.device)
        outs = sample_tokens(self.model.logits(h[mi.selected_idxes]), si, max_top_logprobs=self.max_top_logprobs,
                             plan=plan)
        T = h.shape[0]
        C = 128 if T % 128 == 0 else T
        tg = torch.from_numpy(np.asarray(targets, np.int64)).to(self.device)
        t_lps, top_ids, top_lps = [], [], []
        for c in range(0, T, C):
            lp = torch.log_softmax(self.model.logits(h[c : c + C]).float(), dim=-1)
            t_lps.append(lp.gather(1, tg[c : c + C, None])[:, 0])
            vals, ids = torch.topk(lp, top_k, dim=-1)
            top_ids.append(ids.int())
            top_lps.append(vals)
        return outs, (torch.cat(t_lps), torch.cat(top_ids), torch.cat(top_lps))

    @torch.inference_mode()
    def execute_multi(self, mi: ModelInputs, si: SamplingInputs, num_steps: int, page_size: int) -> ModelOutputs:
        """Run `num_steps` decode micro-steps of a decode-only batch in one
        dispatch (with graphs on, one replay); returns ModelOutputs whose
        fields have a leading [num_steps] dim, on the device. The KV cache
        is updated in place."""
        if self.kv_cache is None:
            raise RuntimeError("init_kv_cache first")
        plan = SamplingPlan.of(si)
        if self.graphs is not None:
            return self.graphs.run_multi(mi, si, plan, num_steps, page_size)
        check_multi_step_plan(plan)
        return self._multi_steps(mi.to(self.device), si.to(self.device), plan, num_steps, page_size)

    @torch.inference_mode()
    def warmup(self, block_size: int, mode: str = "fast", max_tokens: int = 512, max_seqs: int = 128,
               max_context_len: int = 4096, multi_steps: int = 1) -> None:
        """Capture the reference's warmup buckets (warmup_buckets), largest
        first, each from its minimal batch: the counterpart of the
        reference's compile at init; with multi_steps > 1 also the
        multi-step graph of every decode bucket, with the all-greedy plan.
        Needs init_graphs."""
        buckets = warmup_buckets(block_size, mode, max_tokens, max_seqs, max_context_len)
        if not buckets:
            return
        if self.graphs is None:
            raise RuntimeError("warmup captures step graphs: init_graphs first")
        t0 = time.monotonic()
        self.graphs.in_warmup = True
        try:
            for T, S, MAXP, decode_only in sorted(buckets, reverse=True):
                mi = minimal_inputs(T, S, MAXP)
                if self.graphs.key(T, S, MAXP, decode_only) not in self.graphs.graphs:
                    self.graphs.run(mi, decode_only)
                if multi_steps > 1 and decode_only:
                    si = minimal_sampling_inputs(S)
                    key = self.graphs.multi_key(T, S, MAXP, multi_steps, block_size, SamplingPlan.of(si))
                    if key not in self.graphs.graphs:
                        self.graphs.run_multi(mi, si, key[-1], multi_steps, block_size)
        finally:
            self.graphs.in_warmup = False
        logger.info("warmed %d buckets (%s, %d-step decode) into %d graphs in %.1fs", len(buckets), mode,
                    multi_steps, len(self.graphs.graphs), time.monotonic() - t0)
