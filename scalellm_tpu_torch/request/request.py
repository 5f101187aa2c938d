"""Request — one API call, owning one or more Sequences.

Equivalent of the reference's Request
(reference: src/request/request.h:26-113): prompt + tokens, n/best_of,
sampling/stopping params, priority, stream/echo flags, lazy n-expansion after
prefill (so prefill compute is shared via the prefix cache), output assembly,
and cancellation.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, List, Optional, Sequence as Seq

from scalellm_tpu_torch.request.output import (
    FinishReason,
    Priority,
    RequestOutput,
    SequenceOutput,
    Status,
    StatusCode,
    Usage,
)
from scalellm_tpu_torch.request.sequence import Sequence
from scalellm_tpu_torch.request.stopping import StoppingCriteria
from scalellm_tpu_torch.sampling.params import SamplingParams

# Callback invoked with streamed/final outputs. Returning False cancels the
# request (client disconnected) — reference: response_handler.cpp:90-93.
OnOutput = Callable[[RequestOutput], bool]

_req_counter = itertools.count()


def _gen_request_id(prefix: str = "cmpl") -> str:
    import uuid

    return f"{prefix}-{uuid.uuid4().hex[:22]}"


class Request:
    def __init__(
        self,
        prompt: str,
        prompt_tokens: Seq[int],
        sampling_params: SamplingParams,
        stopping_criteria: StoppingCriteria,
        on_output: OnOutput,
        stream: bool = False,
        priority: Priority = Priority.NORMAL,
        request_id: Optional[str] = None,
        enable_prefix_cache: bool = True,
        guided_fsm=None,  # Optional[constrained.TokenFsm], shared by sequences
        lora_slot: int = 0,  # LoRA adapter slot (0 = base model)
    ):
        self.guided_fsm = guided_fsm
        self.id = request_id or _gen_request_id()
        self.prompt = prompt
        self.prompt_tokens = list(prompt_tokens)
        self.sampling_params = sampling_params
        self.stopping_criteria = stopping_criteria
        self.on_output = on_output
        self.stream = stream
        self.priority = priority
        self.created_time = time.monotonic()
        self.arrival_seq = next(_req_counter)  # FCFS tiebreaker
        self._cancelled = False
        self._enable_prefix_cache = enable_prefix_cache
        self.lora_slot = lora_slot

        n = sampling_params.n
        best_of = sampling_params.best_of or n
        self.num_to_return = n
        self.num_sequences_target = best_of
        # Lazy expansion: start with one sequence; expand to best_of after its
        # prefill KV exists so siblings share it via the prefix cache
        # (reference: continuous_scheduler.cpp:137-142). Without prefix cache
        # the expansion must happen upfront.
        self.sequences: List[Sequence] = []
        initial = 1 if (best_of > 1 and enable_prefix_cache) else best_of
        for i in range(initial):
            self.sequences.append(self._make_sequence(i))

    def _make_sequence(self, index: int) -> Sequence:
        guided = None
        if self.guided_fsm is not None:
            from scalellm_tpu_torch.constrained.tokenmap import GuidedState

            guided = GuidedState(self.guided_fsm)  # one cursor per sequence
        seq = Sequence(
            index=index,
            token_ids=self.prompt_tokens,
            sampling_params=self.sampling_params,
            stopping_criteria=self.stopping_criteria,
            prompt=self.prompt,
            echo=self.sampling_params.echo,
            guided=guided,
        )
        seq.request = self  # backref for O(1) scheduler lookups
        seq.lora_slot = self.lora_slot
        return seq

    # ------------------------------------------------------------- expansion

    def should_expand_sequences(self) -> bool:
        """(reference: request.h should_expand_sequences) — expand once the
        first sequence's prefill is materialized in KV."""
        if len(self.sequences) >= self.num_sequences_target:
            return False
        first = self.sequences[0]
        return first.num_kv_cache_tokens() >= first.num_prompt_tokens

    def expand_sequences(self) -> None:
        while len(self.sequences) < self.num_sequences_target:
            self.sequences.append(self._make_sequence(len(self.sequences)))

    # ------------------------------------------------------------- state

    def cancel(self) -> None:
        self._cancelled = True
        for seq in self.sequences:
            seq.is_cancelled = True

    @property
    def is_cancelled(self) -> bool:
        return self._cancelled

    def is_finished(self) -> bool:
        return (
            len(self.sequences) >= self.num_sequences_target
            and all(s.is_finished() for s in self.sequences)
        ) or self._cancelled

    # ------------------------------------------------------------- output

    def build_usage(self) -> Usage:
        return Usage(
            num_prompt_tokens=self.sequences[0].num_prompt_tokens if self.sequences else 0,
            num_generated_tokens=sum(s.num_generated_tokens for s in self.sequences),
        )

    def build_output(self, tokenizer) -> RequestOutput:
        """Final (non-delta) output (reference: request.cpp build_output).

        Picks the best `n` of `best_of` sequences by mean logprob when
        available, else the first n.
        """
        seqs = self.sequences
        if self.num_sequences_target > self.num_to_return:
            def score(s: Sequence) -> float:
                lps = [lp.logprob for lp in s.logprobs if lp is not None]
                return sum(lps) / len(lps) if lps else 0.0

            if any(s.logprobs for s in seqs):
                seqs = sorted(seqs, key=score, reverse=True)
            seqs = seqs[: self.num_to_return]

        outputs: List[SequenceOutput] = []
        for out_idx, seq in enumerate(seqs):
            so = seq.build_final_output(tokenizer)
            so.index = out_idx
            outputs.append(so)
        return RequestOutput(
            request_id=self.id,
            prompt=self.prompt,
            status=Status(StatusCode.OK),
            outputs=outputs,
            usage=self.build_usage(),
            finished=True,
            # all n sequences share the prompt — scores live on the first
            prompt_logprobs=self.sequences[0].prompt_logprobs
            if self.sequences
            else None,
        )
