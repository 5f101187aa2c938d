"""Sequence — one generation stream within a request.

Re-design of the reference's Sequence
(reference: src/request/sequence.h:43, sequence.cpp). Tracks token ids,
per-engine KV-cache progress (dual counters for speculative decoding), the
KV block list, finish-state caching, logprob storage, and incremental
detokenization state.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence as Seq

from scalellm_tpu_torch.memory.block import Block
from scalellm_tpu_torch.request.incremental_decoder import IncrementalDecoder
from scalellm_tpu_torch.request.output import FinishReason, LogProb, LogProbData, SequenceOutput
from scalellm_tpu_torch.request.stopping import StoppingCriteria
from scalellm_tpu_torch.sampling.params import SamplingParams


class EngineType:
    """Which engine's KV progress to account (reference: sequence.h:22-29).

    LLM = target model; SSM = draft model for speculative decoding.
    """

    LLM = 0
    SSM = 1


_seq_counter = itertools.count()


class Sequence:
    def __init__(
        self,
        index: int,
        token_ids: Seq[int],
        sampling_params: SamplingParams,
        stopping_criteria: StoppingCriteria,
        prompt: str = "",
        echo: bool = False,
        capacity: int = 0,
        guided=None,  # Optional[constrained.GuidedState] — one per sequence
    ):
        self.guided = guided
        self.seq_id = next(_seq_counter)
        self._bids_np = None  # cached np.int32 block ids (batch-prep hot path)
        self.index = index  # index within the parent request (for `n`)
        self.prompt = prompt
        self._num_prompt_tokens = len(token_ids)
        self._token_ids: List[int] = list(token_ids)
        # token id -> occurrence count, for repetition/frequency penalties
        # (reference: sequence.h token_to_count_map_)
        self._token_counts: Dict[int, int] = {}
        for t in self._token_ids:
            self._token_counts[t] = self._token_counts.get(t, 0) + 1

        self.sampling_params = sampling_params
        self.stopping_criteria = stopping_criteria

        # KV-cache progress per engine type (reference: sequence.h:118-125).
        # num_kv_cache_tokens[e] = tokens whose KV is materialized for engine e.
        self._num_kv_cache_tokens = [0, 0]
        self.engine_type = EngineType.LLM

        # KV blocks (shared between engine types in shared-device spec mode).
        self.blocks: List[Block] = []
        # Number of tokens covered by prefix-cache shared blocks.
        self._shared_kv_tokens = 0

        # finish state cache (reference: sequence.h finish_status_invalidated_)
        self._finish_reason = FinishReason.NONE
        self._finish_state_valid = False
        self._num_hidden_tail_tokens = 0  # stop-token(s) excluded from text

        # Streaming/detok state.
        self.decoder = IncrementalDecoder(
            prompt,
            self._num_prompt_tokens,
            echo=echo,
            skip_special_tokens=sampling_params.skip_special_tokens,
        )
        # logprobs per generated token (None entries when not requested)
        self.logprobs: List[Optional[LogProb]] = []
        # teacher-forced prompt logprobs (SamplingParams.prompt_logprobs):
        # entry i scores prompt token i given tokens [0, i); entry 0 is
        # always None (no conditioning context). Filled position-indexed by
        # Batch.process_prompt_scores.
        self.prompt_logprobs: Optional[List[Optional[LogProb]]] = (
            [None] * self._num_prompt_tokens
            if sampling_params.prompt_logprobs is not None
            else None
        )

        self.created_time = time.monotonic()
        self.first_token_time: Optional[float] = None
        self.last_token_time: Optional[float] = None
        # output text already delivered to the stream
        self._delivered_text_len = 0
        self.is_cancelled = False

        # Async pipelined scheduling (scheduler/continuous_scheduler.py):
        # trailing sampled-but-unfetched tokens. The value lives on device
        # (previous step's ModelOutputs) until resolve; the list holds a -1
        # placeholder so num_tokens/KV bookkeeping see the right lengths.
        self._num_pending = 0
        # Row of this sequence in the in-flight batch's sampled outputs
        # (device-side token feedback gathers from it).
        self._pending_src = -1
        # LoRA adapter slot (0 = base model); set by the parent Request.
        self.lora_slot = 0

    def prefix_key_tokens(self, end: int) -> List[int]:
        """Token key for prefix-cache match/insert over positions [0, end).
        LoRA sequences salt the key with the adapter slot (high bits above
        any real vocab id) — their KV differs from the base model's, so
        cross-adapter sharing would serve WRONG cached KV."""
        toks = self._token_ids[:end]
        if self.lora_slot:
            salt = self.lora_slot << 24
            return [t | salt for t in toks]
        return toks

    # ------------------------------------------------------------------ tokens

    @property
    def token_ids(self) -> List[int]:
        return self._token_ids

    @property
    def num_prompt_tokens(self) -> int:
        return self._num_prompt_tokens

    @property
    def num_tokens(self) -> int:
        return len(self._token_ids)

    @property
    def num_generated_tokens(self) -> int:
        # user-facing stat: pending placeholders don't count until resolved
        return (
            len(self._token_ids) - self._num_pending - self._num_prompt_tokens
        )

    @property
    def token_counts(self) -> Dict[int, int]:
        return self._token_counts

    def set_prompt_logprob(self, position: int, lp: LogProb) -> None:
        """Record the teacher-forced logprob of prompt token `position`
        (idempotent — safe under preemption + prefill recompute)."""
        if self.prompt_logprobs is not None and 0 < position < len(
            self.prompt_logprobs
        ):
            self.prompt_logprobs[position] = lp

    def append_token(self, token_id: int, logprob: Optional[LogProb] = None) -> None:
        """Append one generated token (reference: sequence.h append_token)."""
        self._token_ids.append(int(token_id))
        self._register_token(int(token_id), logprob)

    def _register_token(self, token_id: int, logprob: Optional[LogProb]) -> None:
        """Bookkeeping shared by append_token and resolve_pending_token."""
        self._token_counts[token_id] = self._token_counts.get(token_id, 0) + 1
        self._finish_state_valid = False
        if self.guided is not None:
            self.guided.advance(token_id)
        if logprob is not None or self.sampling_params.logprobs:
            self.logprobs.append(logprob)
        now = time.monotonic()
        # Serving latency metrics (reference: continuous_scheduler.cpp:46-54
        # TTFT + inter-token histograms).
        from scalellm_tpu_torch.utils.metrics import COUNTERS, HISTOGRAMS

        if self.first_token_time is None:
            self.first_token_time = now
            HISTOGRAMS.observe(
                "time_to_first_token_latency_seconds", now - self.created_time
            )
        elif self.last_token_time is not None:
            HISTOGRAMS.observe(
                "inter_token_latency_seconds", now - self.last_token_time
            )
        self.last_token_time = now
        COUNTERS.inc("num_generated_tokens_total")

    # -------------------------------------------------- async pending tokens

    @property
    def has_pending(self) -> bool:
        return self._num_pending > 0

    @property
    def num_resolved_tokens(self) -> int:
        """Tokens whose values are known on the host (excludes the trailing
        pending placeholders of the async pipeline)."""
        return len(self._token_ids) - self._num_pending

    def append_pending_token(self, src_row: int) -> None:
        """Reserve a slot for a token sampled by an in-flight step; the value
        arrives via resolve_pending_token. src_row = the sequence's row in
        that step's sampled outputs (device-side token feedback)."""
        self._token_ids.append(-1)
        self._num_pending += 1
        self._pending_src = src_row

    @property
    def pending_src(self) -> int:
        return self._pending_src

    def resolve_pending_token(
        self, token_id: int, logprob: Optional[LogProb] = None
    ) -> None:
        """Fill the oldest pending placeholder with its fetched value."""
        assert self._num_pending > 0
        pos = len(self._token_ids) - self._num_pending
        self._token_ids[pos] = int(token_id)
        self._num_pending -= 1
        self._register_token(int(token_id), logprob)

    def pop_pending_token(self) -> None:
        """Drop the newest pending placeholder (overshoot of a sequence that
        finished while the next step was already in flight; the in-flight
        sample is discarded)."""
        assert self._num_pending > 0 and self._token_ids[-1] == -1
        self._token_ids.pop()
        self._num_pending -= 1
        # KV counters never cover pending positions, so no rewind is needed:
        # the dropped slot's KV (if the in-flight step wrote it) belongs to a
        # released block and is never read.
        self._finish_state_valid = False

    def would_finish_by_length(self) -> bool:
        """True when the pending token(s) already reach a length limit — the
        async scheduler skips such sequences instead of dispatching a step
        whose output would be discarded."""
        sc = self.stopping_criteria
        gen = len(self._token_ids) - self._num_prompt_tokens
        if sc.max_tokens and gen >= sc.max_tokens:
            return True
        return bool(sc.max_context_len) and len(self._token_ids) >= sc.max_context_len

    def validate_tokens(self, accepted_token_ids: Seq[int]) -> int:
        """Speculative validation (reference: sequence.cpp:92 validate_tokens).

        The last num_spec+1 tokens of the sequence are draft tokens plus a
        bonus slot; `accepted_token_ids` holds the accepted prefix followed by
        -1 padding. Truncates rejected tokens and rewinds the KV counters.
        Returns the number of accepted tokens (including resampled/bonus).
        """
        num_spec = len(accepted_token_ids) - 1
        assert num_spec >= 1, "validate_tokens needs at least 2 candidate tokens"
        # The draft tokens currently occupy the tail of _token_ids.
        base_len = len(self._token_ids) - num_spec
        accepted: List[int] = []
        for tid in accepted_token_ids:
            if tid < 0:
                break
            accepted.append(int(tid))
        assert accepted, "at least one token must be accepted"

        # Remove the draft tail from counts, then re-append accepted tokens,
        # stopping at the first token that finishes the sequence (an accepted
        # eos/stop mid-row must truncate the rest — reference: sequence.cpp:92
        # checks finish per appended token).
        for tid in self._token_ids[base_len:]:
            self._token_counts[tid] -= 1
            if self._token_counts[tid] == 0:
                del self._token_counts[tid]
        del self._token_ids[base_len:]
        appended: List[int] = []
        for tid in accepted:
            self._token_ids.append(tid)
            self._token_counts[tid] = self._token_counts.get(tid, 0) + 1
            appended.append(tid)
            self._finish_state_valid = False
            if self.finish_reason() != FinishReason.NONE:
                break
        accepted = appended

        # Rewind KV counters: KV beyond the accepted prefix is stale. The KV
        # for a token at position i is valid only if token i is kept; the last
        # accepted token's KV hasn't been computed yet.
        new_len = len(self._token_ids)
        for et in (EngineType.LLM, EngineType.SSM):
            self._num_kv_cache_tokens[et] = min(
                self._num_kv_cache_tokens[et], new_len - 1
            )
        self._finish_state_valid = False
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
        return len(accepted)

    # ------------------------------------------------------------------ kv cache

    def num_kv_cache_tokens(self, engine_type: Optional[int] = None) -> int:
        et = self.engine_type if engine_type is None else engine_type
        return self._num_kv_cache_tokens[et]

    def restore_kv_tokens(self, num_tokens: int) -> None:
        """Set the LLM-engine KV counter after a swap-in restored staged
        pages (memory/kv_swap.py). Capacity must already cover it."""
        assert num_tokens <= self.kv_cache_capacity
        self._num_kv_cache_tokens[EngineType.LLM] = num_tokens

    def commit_kv_cache(self, num_tokens: int, engine_type: Optional[int] = None) -> None:
        """Record that KV for `num_tokens` more tokens is now materialized
        (reference: sequence.h:202 commit_kv_cache)."""
        et = self.engine_type if engine_type is None else engine_type
        self._num_kv_cache_tokens[et] += num_tokens
        assert self._num_kv_cache_tokens[et] <= self.kv_cache_capacity

    def set_shared_kv_tokens(self, n: int) -> None:
        """Prefix-cache hit: first n tokens' KV comes from shared blocks."""
        self._shared_kv_tokens = n
        for et in (EngineType.LLM, EngineType.SSM):
            self._num_kv_cache_tokens[et] = max(self._num_kv_cache_tokens[et], n)

    @property
    def kv_cache_capacity(self) -> int:
        if not self.blocks:
            return 0
        return len(self.blocks) * self.blocks[0].size

    def kv_cache_slots(self, start: int, end: int) -> List[int]:
        """Global slot ids for token positions [start, end)
        (reference: sequence.h:131 kv_cache_slots)."""
        if not self.blocks:
            return []
        block_size = self.blocks[0].size
        slots = []
        for pos in range(start, end):
            block = self.blocks[pos // block_size]
            slots.append(block.id * block_size + pos % block_size)
        return slots

    def kv_slots_array(self, start: int, end: int) -> "np.ndarray":
        """Vectorized kv_cache_slots over the cached block-id array — the
        batch-prep hot path (profiled: per-token Python loops dominated
        prepare_model_inputs at large S)."""
        import numpy as np

        bids = self.block_ids_array()
        bs = self.blocks[0].size
        pos = np.arange(start, end, dtype=np.int32)
        return bids[pos // bs] * bs + pos % bs

    def block_ids(self) -> List[int]:
        return [b.id for b in self.blocks]

    def block_ids_array(self) -> "np.ndarray":
        """Cached np.int32 view of block ids (rebuilt only after the block
        list changes)."""
        import numpy as np

        if self._bids_np is None or len(self._bids_np) != len(self.blocks):
            self._bids_np = np.asarray(
                [b.id for b in self.blocks], dtype=np.int32
            )
        return self._bids_np

    def append_blocks(self, blocks: Seq[Block]) -> None:
        self.blocks.extend(blocks)
        self._bids_np = None

    def release_blocks(self) -> None:
        """Free all blocks (keeps nothing cached). Resets KV counters."""
        self.blocks = []
        self._bids_np = None
        self._num_kv_cache_tokens = [0, 0]
        self._shared_kv_tokens = 0

    # ------------------------------------------------------------------ finish

    def finish_reason(self) -> FinishReason:
        if not self._finish_state_valid:
            # Pending placeholders carry no value yet: evaluate stopping on
            # the resolved prefix only.
            tokens = (
                self._token_ids[: -self._num_pending]
                if self._num_pending
                else self._token_ids
            )
            reason, hide = self.stopping_criteria.check_finished(
                tokens, self._num_prompt_tokens
            )
            if reason == FinishReason.NONE and self.guided is not None:
                # Constraint complete (EOS-equivalent) or token-level dead
                # end (no vocab token matches any continuation): stop.
                if self.guided.finished or self.guided.exhausted():
                    reason, hide = FinishReason.STOP, None
            self._finish_reason = reason
            self._num_hidden_tail_tokens = hide or 0
            self._finish_state_valid = True
        return self._finish_reason

    def is_finished(self) -> bool:
        return self.is_cancelled or self.finish_reason() != FinishReason.NONE

    # ------------------------------------------------------------------ output

    def build_delta_output(self, tokenizer) -> Optional[SequenceOutput]:
        """Stream any newly-finalized text
        (reference: sequence.h:188 build_delta_output_until)."""
        end = self.num_resolved_tokens
        if self.is_finished():
            end -= self._num_hidden_tail_tokens
        visible = self._token_ids[:end]
        prev_offset = self.decoder.output_offset
        delta_text = self.decoder.decode(visible, tokenizer)
        new_offset = self.decoder.output_offset
        if not delta_text and not self.is_finished():
            return None
        delta_tokens = visible[prev_offset:new_offset]
        out = SequenceOutput(
            index=self.index,
            text=delta_text,
            token_ids=list(delta_tokens),
            finish_reason=self.finish_reason() if self.is_finished() else None,
            logprobs=self._slice_logprobs(prev_offset, new_offset),
        )
        return out

    def build_final_output(self, tokenizer) -> SequenceOutput:
        """Non-streaming: full output text at once."""
        end = self.num_resolved_tokens - self._num_hidden_tail_tokens
        visible = self._token_ids[:end]
        prev_offset = self.decoder.output_offset
        text = self.decoder.decode(visible, tokenizer)
        new_offset = self.decoder.output_offset
        return SequenceOutput(
            index=self.index,
            text=text,
            token_ids=list(visible[prev_offset:new_offset]),
            finish_reason=self.finish_reason() if self.is_finished() else None,
            logprobs=self._slice_logprobs(prev_offset, new_offset),
        )

    def _slice_logprobs(self, start: int, end: int) -> Optional[List[LogProb]]:
        if not self.sampling_params.logprobs or not self.logprobs:
            return None
        # logprobs[i] corresponds to generated token i (position
        # num_prompt_tokens + i in the sequence).
        lo = max(start - self._num_prompt_tokens, 0)
        hi = max(end - self._num_prompt_tokens, 0)
        sliced = [lp for lp in self.logprobs[lo:hi] if lp is not None]
        return sliced or None
