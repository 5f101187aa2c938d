"""Prompt-lookup (n-gram) speculative decoding, no draft model
(counterpart of scalellm_tpu/speculative/ngram.py).

The proposer copies the continuation of the most recent earlier occurrence
of the sequence's trailing n-gram from its own history (prompt and
generated text); one target pass verifies the k proposed tokens and samples
the replacement or bonus token. A proposal is deterministic, so acceptance
uses the one-hot form of the rejection sampler: a token is accepted with
probability p_target(token) (greedy: iff it is the target's argmax, which
keeps greedy decoding lossless), and the recovery distribution is p_target
with the proposed token zeroed.

The verify round (NgramSpecExecutor) is one function on the device, captured
per key into the target executor's StepGraphs with graphs on, as the draft
round is (spec_executor.py).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from scalellm_tpu_torch.engine.batch import Batch
from scalellm_tpu_torch.engine.llm_engine import EngineOptions, LLMEngine
from scalellm_tpu_torch.request.sequence import EngineType
from scalellm_tpu_torch.sampling.sampler import SamplingPlan
from scalellm_tpu_torch.speculative.rejection_sampler import rejection_sample_onehot
from scalellm_tpu_torch.speculative.spec_executor import RoundRunner, round_arrays, round_sampling, verify_probs
from scalellm_tpu_torch.utils.metrics import COUNTERS, HISTOGRAMS


def propose_ngram(tokens: List[int], k: int, min_n: int = 2, max_n: int = 4) -> Optional[List[int]]:
    """Propose k continuation tokens by prompt lookup.

    Finds the longest trailing n-gram (max_n down to min_n) that occurred
    earlier in `tokens` and returns the k tokens that followed its most
    recent earlier occurrence (padded by repeating the final token when the
    match sits near the end). None when no n-gram recurs."""
    L = len(tokens)
    if L < min_n + 1:
        return None
    t = np.asarray(tokens, dtype=np.int32)
    for n in range(min(max_n, L - 1), min_n - 1, -1):
        pattern = t[L - n:]
        # Start positions of an earlier occurrence (the trailing one starts
        # at L - n and is excluded).
        windows = np.lib.stride_tricks.sliding_window_view(t[: L - 1], n)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        hits = hits[hits < L - n]
        if hits.size == 0:
            continue
        start = int(hits[-1]) + n  # the continuation of the most recent match
        cont = t[start : start + k]
        if cont.size == 0:
            continue
        out = cont.tolist()
        while len(out) < k:
            out.append(out[-1])
        return out
    return None


class NgramSpecExecutor(RoundRunner):
    """The n-gram round: the target's verify forward over the host's
    proposals (the round buffer's draft_ids) and rejection_sample_onehot."""

    kind = "ngram_round"

    def _round(self, v: Dict[str, torch.Tensor], plan: SamplingPlan, S: int) -> torch.Tensor:
        si = round_sampling(v)
        d_ids = v["draft_ids"]
        t_probs = verify_probs(self.target, v, d_ids, si, plan, S, self.k)
        accepted = rejection_sample_onehot(d_ids, t_probs, v["temperatures"] > 0.0, si.seeds)
        return torch.cat([accepted, d_ids], dim=1)

    def execute(self, arrays: Dict[str, np.ndarray], S: int, MAXP: int) -> np.ndarray:
        """The accepted ids [S, k+1] of one round, numpy."""
        return self.run(arrays, S, MAXP)[:, : self.k + 1]


class NgramSpeculativeEngine:
    """The scheduler-facing engine of prompt lookup, where an LLMEngine goes
    (the same surface); chosen by num_speculative_tokens > 0 without a
    draft model. A step runs the plain target step unless it is decode-only
    and some sequence has a proposal; sequences without one verify a filler
    (their last token, k times)."""

    def __init__(self, options: EngineOptions, min_ngram: int = 2, max_ngram: int = 4):
        if options.num_speculative_tokens <= 0:
            raise ValueError("num_speculative_tokens must be positive")
        self.options = options
        self.k = options.num_speculative_tokens
        self.min_ngram = min_ngram
        self.max_ngram = max_ngram
        self.target = LLMEngine(options)
        self.spec_executor = NgramSpecExecutor(self.target.executor, self.k)
        self.tokenizer = self.target.tokenizer
        self.model_args = self.target.model_args
        self.block_manager = self.target.block_manager
        self._step_counter = 0

    def execute_model(self, batch: Batch) -> None:
        if not batch.entries:
            return
        self._step_counter += 1
        seqs = [e.seq for e in batch.entries]
        is_decode = all(e.num_tokens == 1 and e.seq.num_kv_cache_tokens(EngineType.LLM) > 0
                        for e in batch.entries)
        proposals = None
        if is_decode:
            proposals = [propose_ngram(seq.token_ids, self.k, self.min_ngram, self.max_ngram) for seq in seqs]
            if all(p is None for p in proposals):
                proposals = None  # nothing to verify: the plain step is cheaper
        if proposals is None:
            self.target.execute_model(batch)
            return
        self._execute_speculative(seqs, proposals)

    def _execute_speculative(self, seqs, proposals) -> None:
        k = self.k
        # A sequence without a proposal verifies a filler, rejected at 0
        # unless the model wants to repeat its last token.
        filled = [p if p is not None else [seq.token_ids[-1]] * k for seq, p in zip(seqs, proposals)]
        arrays, S, MAXP = round_arrays(seqs, k, self._step_counter, filled)
        t0 = time.monotonic()
        accepted = self.spec_executor.execute(arrays, S, MAXP)
        HISTOGRAMS.observe("target_execution_latency_seconds", time.monotonic() - t0)
        num_accepted = 0
        for s, seq in enumerate(seqs):
            for i in range(k):
                seq.append_token(int(filled[s][i]))
            seq.commit_kv_cache(k + 1, EngineType.LLM)
            num_accepted += seq.validate_tokens(accepted[s].tolist())
        COUNTERS.inc("num_accepted_tokens_total", num_accepted)
        COUNTERS.inc("num_draft_tokens_total", k * sum(p is not None for p in proposals))
