"""Batch — turns scheduled Sequences and their token budgets into padded
model inputs, and writes sampled tokens back
(counterpart of scalellm_tpu/engine/batch.py): synchronously, as N samples
a sequence of a multi-step dispatch, or as pending tokens of an async step
that are resolved when its outputs are fetched.

A batch with a prompt_logprobs sequence whose prompt tokens enter this step
also carries the prompt-scoring targets (score_targets: each position's
next prompt token) that the engine's score step reads, and writes the
teacher-forced logprobs back (process_prompt_scores).

Arrays are padded to the same bucket ladders as the reference package, so a
batch here has the same shapes, padding included:
  - token slots beyond the real tokens: ids/positions/seg 0, kv slot 0
    (page 0 is the reserved padding block)
  - sequence slots beyond the real sequences: kv_len 0, block table all-0,
    selected idx 0, seq_mask 0; cu_q_lens repeats its last value
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Optional, Sequence as Seq, Tuple

import numpy as np

from scalellm_tpu_torch.engine.params import ModelInputs, SamplingInputs
from scalellm_tpu_torch.request.output import LogProb, LogProbData
from scalellm_tpu_torch.request.sequence import Sequence

TOKEN_BUCKETS = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384]
SEQ_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256]
PAGE_BUCKETS = [4, 16, 64, 256, 1024, 4096, 16384]


def pick_bucket(ladder: Seq[int], n: int) -> int:
    i = bisect.bisect_left(ladder, n)
    if i == len(ladder):
        raise ValueError(f"{n} exceeds largest bucket {ladder[-1]}")
    return ladder[i]


@dataclass
class BatchEntry:
    seq: Sequence
    # New tokens to process for this sequence this step (chunked prefill:
    # may be fewer than the uncached tokens).
    num_tokens: int
    # Whether this step samples a token for the sequence (false for a
    # prefill chunk that does not reach the end of the prompt).
    needs_sample: bool


@dataclass
class Batch:
    """One scheduler step's worth of sequences."""

    entries: List[BatchEntry] = field(default_factory=list)
    # (mask [T] bool, gather [T] int32) of the token rows whose value is the
    # previous step's sample, still on the device, or None. Set by
    # prepare_model_inputs; the engine merges those rows on the device.
    pending_fix: Optional[Tuple[np.ndarray, np.ndarray]] = field(default=None, init=False, repr=False)
    # Prompt scoring (SamplingParams.prompt_logprobs), set by
    # prepare_model_inputs: [T] the next prompt token of each prefill
    # position (0 elsewhere), the largest top-k asked for (None: no scoring
    # this step) and each scored entry's (entry, first row, start, end).
    score_targets: Optional[np.ndarray] = field(default=None, init=False, repr=False)
    score_top_k: Optional[int] = field(default=None, init=False, repr=False)
    _score_spans: list = field(default_factory=list, init=False, repr=False)
    # [S] int32 each sequence's LoRA adapter slot (padding rows: 0), set by
    # prepare_model_inputs; the engine passes it as ModelInputs.lora_ids
    # when adapters are loaded.
    lora_slots: Optional[np.ndarray] = field(default=None, init=False, repr=False)

    def add(self, seq: Sequence, num_tokens: int) -> None:
        cached = seq.num_kv_cache_tokens()
        if num_tokens <= 0 or cached + num_tokens > seq.num_tokens:
            raise ValueError(f"bad chunk: {num_tokens} tokens after {cached} cached")
        self.entries.append(
            BatchEntry(seq, num_tokens, cached + num_tokens == seq.num_tokens)
        )

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def is_decode_only(self) -> bool:
        """Every sequence contributes exactly one query token: the step a
        model with a decode kernel (MLA) sends to it."""
        return bool(self.entries) and all(e.num_tokens == 1 for e in self.entries)

    @property
    def num_tokens(self) -> int:
        return sum(e.num_tokens for e in self.entries)

    def prepare_model_inputs(
        self, block_size: int, step_counter: int = 0
    ) -> Tuple[ModelInputs, SamplingInputs, np.ndarray]:
        """Flatten the batch into padded numpy arrays.

        Returns (model_inputs, sampling_inputs, needs_sample_mask[S] bool)."""
        S_real = len(self.entries)
        T = pick_bucket(TOKEN_BUCKETS, max(self.num_tokens, 1))
        S = pick_bucket(SEQ_BUCKETS, max(S_real, 1))
        max_pages_real = max((len(e.seq.blocks) for e in self.entries), default=1)
        MAXP = pick_bucket(PAGE_BUCKETS, max(max_pages_real, 1))

        token_ids = np.zeros(T, dtype=np.int32)
        positions = np.zeros(T, dtype=np.int32)
        token_seg = np.zeros(T, dtype=np.int32)
        new_kv_slot_ids = np.zeros(T, dtype=np.int32)
        block_tables = np.zeros((S, MAXP), dtype=np.int32)
        kv_lens = np.zeros(S, dtype=np.int32)
        cu_q_lens = np.zeros(S + 1, dtype=np.int32)
        selected_idxes = np.zeros(S, dtype=np.int32)
        seq_mask = np.zeros(S, dtype=np.float32)
        needs_sample = np.zeros(S, dtype=bool)
        self.lora_slots = np.zeros(S, dtype=np.int32)

        temperatures = np.zeros(S, dtype=np.float32)
        top_ks = np.zeros(S, dtype=np.int32)
        top_ps = np.ones(S, dtype=np.float32)
        freq_p = np.zeros(S, dtype=np.float32)
        pres_p = np.zeros(S, dtype=np.float32)
        rep_p = np.ones(S, dtype=np.float32)
        seeds = np.zeros(S, dtype=np.uint32)

        # Unique-token histograms, built only when a sequence uses a penalty.
        use_penalties = any(
            e.seq.sampling_params.frequency_penalty != 0.0
            or e.seq.sampling_params.presence_penalty != 0.0
            or e.seq.sampling_params.repetition_penalty != 1.0
            for e in self.entries
        )
        U = 0
        if use_penalties:
            U = max(len(e.seq.token_counts) for e in self.entries)
            U = max(8, 1 << (U - 1).bit_length())  # pad to a pow2 bucket
        unique_ids = np.zeros((S, max(U, 1)), dtype=np.int32)
        unique_counts = np.zeros((S, max(U, 1)), dtype=np.int32)

        B = 0
        if any(e.seq.sampling_params.logit_bias for e in self.entries):
            B = max(len(e.seq.sampling_params.logit_bias or ()) for e in self.entries)
            B = max(8, 1 << (B - 1).bit_length())
        bias_ids = np.zeros((S, max(B, 1)), dtype=np.int32)
        bias_vals = np.zeros((S, max(B, 1)), dtype=np.float32)

        # Guided decoding: W = packed words (ceil(V/32)) when some sequence
        # is constrained this step, else 1 (the sampler skips the stage).
        # Unconstrained rows (padding rows too) are all ones.
        W = 1
        guided_rows = [
            (s, e.seq.guided)
            for s, e in enumerate(self.entries)
            if e.seq.guided is not None and not e.seq.guided.finished
        ]
        if guided_rows:
            W = guided_rows[0][1].fsm.n_words
        allowed_mask = np.full((S, W), 0xFFFFFFFF, dtype=np.uint32)
        for s, g in guided_rows:
            row = g.mask()
            if row is not None:
                allowed_mask[s] = row

        # Async stepping: token rows whose value is still on the device (the
        # previous step's sample), with their row in that step's outputs.
        pending_rows: List[int] = []
        pending_srcs: List[int] = []

        # Prompt scoring: only while a requesting sequence still has prompt
        # tokens entering the batch, so decode-only steps skip it.
        self.score_targets = np.zeros(T, dtype=np.int32)
        self.score_top_k = None
        self._score_spans = []

        t = 0
        for s, e in enumerate(self.entries):
            seq = e.seq
            start = seq.num_kv_cache_tokens()
            end = start + e.num_tokens
            bids = seq.block_ids_array()
            token_ids[t : t + e.num_tokens] = seq.token_ids[start:end]
            if e.num_tokens == 1 and token_ids[t] < 0:  # pending: a placeholder of -1
                pending_rows.append(t)
                pending_srcs.append(seq.pending_src)
                token_ids[t] = 0
            positions[t : t + e.num_tokens] = np.arange(start, end)
            token_seg[t : t + e.num_tokens] = s
            new_kv_slot_ids[t : t + e.num_tokens] = seq.kv_slots_array(start, end)
            block_tables[s, : len(bids)] = bids
            kv_lens[s] = end
            cu_q_lens[s + 1] = t + e.num_tokens
            selected_idxes[s] = t + e.num_tokens - 1
            seq_mask[s] = 1.0
            needs_sample[s] = e.needs_sample
            self.lora_slots[s] = seq.lora_slot

            sp = seq.sampling_params
            temperatures[s] = sp.temperature
            top_ks[s] = sp.top_k if sp.top_k > 0 else 0
            top_ps[s] = sp.top_p
            freq_p[s] = sp.frequency_penalty
            pres_p[s] = sp.presence_penalty
            rep_p[s] = sp.repetition_penalty
            base_seed = sp.seed if sp.seed is not None else seq.seq_id
            seeds[s] = np.uint32((base_seed * 1000003 + step_counter) & 0xFFFFFFFF)
            if use_penalties:
                for u, (tid, cnt) in enumerate(list(seq.token_counts.items())[:U]):
                    unique_ids[s, u] = tid
                    unique_counts[s, u] = cnt
            if B and sp.logit_bias:
                for j, (tid, bv) in enumerate(list(sp.logit_bias.items())[:B]):
                    bias_ids[s, j] = tid
                    bias_vals[s, j] = bv
            n_prompt = seq.num_prompt_tokens
            if sp.prompt_logprobs is not None and start < n_prompt:
                self.score_top_k = max(self.score_top_k or 0, sp.prompt_logprobs)
                self._score_spans.append((e, t, start, end))
                # Position p's target is prompt token p + 1, defined through
                # n_prompt - 2 (the last prompt token's successor is sampled).
                for p in range(start, min(end, n_prompt - 1)):
                    self.score_targets[t + (p - start)] = seq.token_ids[p + 1]
            t += e.num_tokens

        # Padding rows repeat the last cumulative value (zero-length chunks).
        cu_q_lens[S_real + 1 :] = cu_q_lens[S_real]
        self.pending_fix = None
        if pending_rows:
            mask = np.zeros(T, dtype=bool)
            mask[pending_rows] = True
            gather = np.zeros(T, dtype=np.int32)
            gather[pending_rows] = pending_srcs
            self.pending_fix = (mask, gather)
        mi = ModelInputs(
            token_ids=token_ids,
            positions=positions,
            token_seg=token_seg,
            new_kv_slot_ids=new_kv_slot_ids,
            block_tables=block_tables,
            kv_lens=kv_lens,
            cu_q_lens=cu_q_lens,
            num_seqs=np.array([S_real], dtype=np.int32),
            selected_idxes=selected_idxes,
            seq_mask=seq_mask,
        )
        si = SamplingInputs(
            temperatures=temperatures,
            top_ks=top_ks,
            top_ps=top_ps,
            frequency_penalties=freq_p,
            presence_penalties=pres_p,
            repetition_penalties=rep_p,
            unique_token_ids=unique_ids,
            unique_token_counts=unique_counts,
            bias_token_ids=bias_ids,
            bias_values=bias_vals,
            allowed_mask=allowed_mask,
            seeds=seeds,
        )
        return mi, si, needs_sample

    def process_prompt_scores(
        self,
        t_lps: np.ndarray,  # [T]
        top_ids: Optional[np.ndarray],  # [T, K]
        top_lps: Optional[np.ndarray],  # [T, K]
        tokenizer=None,
    ) -> None:
        """Record the teacher-forced prompt logprobs on their sequences, by
        position (Sequence.set_prompt_logprob), so that a prefill recomputed
        after preemption writes the same entries again."""
        for e, t0, start, end in self._score_spans:
            seq = e.seq
            k = seq.sampling_params.prompt_logprobs or 0
            for p in range(start, min(end, seq.num_prompt_tokens - 1)):
                t = t0 + (p - start)
                tid = seq.token_ids[p + 1]
                lp = LogProb(token=tokenizer.id_to_token(tid) if tokenizer else "", token_id=tid,
                             logprob=float(t_lps[t]))
                if k > 0 and top_ids is not None and top_ids.shape[1]:
                    lp.top_logprobs = [
                        LogProbData(token=tokenizer.id_to_token(int(top_ids[t, j])) if tokenizer else "",
                                    token_id=int(top_ids[t, j]), logprob=float(top_lps[t, j]))
                        for j in range(min(k, top_ids.shape[1]))
                    ]
                seq.set_prompt_logprob(p + 1, lp)

    def needs_sync(self) -> bool:
        """True when this batch cannot run under async stepping: guided
        decoding and penalties need the previous token resolved on the host
        before the next step's masks and histograms are built, and prompt
        scoring runs another program (the reference's gate)."""
        for e in self.entries:
            sp = e.seq.sampling_params
            if e.seq.guided is not None:
                return True
            if sp.frequency_penalty != 0.0 or sp.presence_penalty != 0.0 or sp.repetition_penalty != 1.0:
                return True
            if sp.prompt_logprobs is not None:
                return True
        return False

    def can_multi_step(self) -> bool:
        """True when the batch can run as one multi-step decode dispatch:
        decode-only, every row samples, no row's token is pending on the
        device, and nothing needs per-token host feedback (the reference's
        gate)."""
        if not self.is_decode_only:
            return False
        for e in self.entries:
            if not e.needs_sample or e.seq.has_pending:
                return False
        return not self.needs_sync()

    def process_multi_sample_output(
        self,
        next_tokens: np.ndarray,  # [N, S]
        logprobs: Optional[np.ndarray],  # [N, S]
        top_ids: Optional[np.ndarray],  # [N, S, K]
        top_logprobs: Optional[np.ndarray],  # [N, S, K]
        tokenizer=None,
    ) -> None:
        """Append up to N samples a sequence, dropping every one after a
        finish (EOS, stop, max_tokens: the device decoded on). Micro-step i
        writes the KV of its input token, so a sequence that accepts n
        tokens has KV committed for its input plus n - 1 fed-back tokens;
        the last sample's KV is written by the next step, as on the
        single-step path."""
        N = next_tokens.shape[0]
        for s, e in enumerate(self.entries):
            seq = e.seq
            seq.commit_kv_cache(e.num_tokens)
            for i in range(N):
                tid = int(next_tokens[i, s])
                lp = self._build_logprob(
                    seq, tid, s,
                    logprobs[i] if logprobs is not None else None,
                    top_ids[i] if top_ids is not None else None,
                    top_logprobs[i] if top_logprobs is not None else None,
                    tokenizer,
                )
                seq.append_token(tid, lp)
                if seq.is_finished():
                    break
                if i < N - 1:
                    seq.commit_kv_cache(1)

    def append_pending_tokens(self) -> None:
        """Async dispatch: commit KV progress and append a pending
        placeholder for each sample of this step (its value is resolved
        when the step's outputs are fetched)."""
        for s, e in enumerate(self.entries):
            e.seq.commit_kv_cache(e.num_tokens)
            if e.needs_sample:
                e.seq.append_pending_token(src_row=s)

    def resolve_sample_output(
        self,
        next_tokens: np.ndarray,  # [S]
        logprobs: Optional[np.ndarray],
        top_ids: Optional[np.ndarray],
        top_logprobs: Optional[np.ndarray],
        tokenizer=None,
    ) -> None:
        """Async resolve: fill this step's pending tokens with the fetched
        values (KV was committed at dispatch). A sequence that finished or
        was cancelled while the step was in flight drops its sample."""
        for s, e in enumerate(self.entries):
            seq = e.seq
            if not e.needs_sample or not seq.has_pending:
                continue
            if seq.is_finished():
                # finished while in flight: the sample is overshoot
                seq.pop_pending_token()
                continue
            tid = int(next_tokens[s])
            lp = self._build_logprob(seq, tid, s, logprobs, top_ids, top_logprobs, tokenizer)
            seq.resolve_pending_token(tid, lp)
            if seq.is_finished() and seq.has_pending:
                # the next step (already dispatched) sampled past the finish
                seq.pop_pending_token()

    @staticmethod
    def _build_logprob(
        seq, tid, s, logprobs, top_ids, top_logprobs, tokenizer
    ) -> Optional[LogProb]:
        if logprobs is None or not seq.sampling_params.logprobs:
            return None
        lp = LogProb(
            token=tokenizer.id_to_token(tid) if tokenizer else "",
            token_id=tid,
            logprob=float(logprobs[s]),
        )
        k = seq.sampling_params.top_logprobs
        if k > 0 and top_ids is not None:
            lp.top_logprobs = [
                LogProbData(
                    token=tokenizer.id_to_token(int(top_ids[s, j])) if tokenizer else "",
                    token_id=int(top_ids[s, j]),
                    logprob=float(top_logprobs[s, j]),
                )
                for j in range(min(k, top_ids.shape[1]))
            ]
        return lp

    def process_sample_output(
        self,
        next_tokens: np.ndarray,  # [S]
        logprobs: Optional[np.ndarray],  # [S]
        top_ids: Optional[np.ndarray],  # [S, K]
        top_logprobs: Optional[np.ndarray],  # [S, K]
        tokenizer=None,
    ) -> None:
        """Write sampled tokens back into the sequences and commit KV
        progress."""
        for s, e in enumerate(self.entries):
            seq = e.seq
            seq.commit_kv_cache(e.num_tokens)
            if not e.needs_sample:
                continue
            tid = int(next_tokens[s])
            lp = self._build_logprob(seq, tid, s, logprobs, top_ids, top_logprobs, tokenizer)
            seq.append_token(tid, lp)
