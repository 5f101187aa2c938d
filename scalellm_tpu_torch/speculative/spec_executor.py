"""SpecExecutor — a whole speculative round on the device
(counterpart of scalellm_tpu/speculative/spec_executor.py).

The reference runs the round as one jitted program: k draft steps in a
lax.scan (each writing the draft's KV in place and sampling the next draft
token), the target's forward over the k+1-token window of every sequence,
both models' logits processing and softmax, and the rejection sampler; only
the accepted ids [S, k+1] and the draft ids [S, k] go back to the host.

Here the same round is one function of the round's inputs on the device
(SpecExecutor._round). With CUDA graphs on it is captured once per key
(kind, S, MAXP, k, sampling plan) into the target executor's StepGraphs
(run_round: the shared pool and side stream; a capture or replay that fails
raises) and replayed on every later round of that key; with graphs off
(enable_cuda_graph=False) the same function runs eagerly. Nothing in it
reads the device from the host: the KV lengths and cumulative query
lengths are computed on the device from the round's buffer, the sampler's
stages come from the plan decided on the host, and the random draws are
hashes of the seeds (sampling/sampler.py, rejection_sampler.py). The host
reads the round's one output [S, 2k+1] (accepted ids, then draft ids) once.

A round's inputs are one flat int32 array (ROUND_FIELDS, f32 fields as
their bits, the uint32 seeds as int32), padded to the bucket ladders of
engine/batch.py: S rows (SEQ_BUCKETS), MAXP pages (PAGE_BUCKETS). Padding
rows hold zeros: no KV (kv_len 0), their KV writes go to the reserved page
0, and the cumulative query lengths stop growing at num_seqs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from scalellm_tpu_torch.engine.batch import PAGE_BUCKETS, SEQ_BUCKETS, pick_bucket
from scalellm_tpu_torch.engine.params import ModelInputs, SamplingInputs
from scalellm_tpu_torch.sampling.sampler import SamplingPlan, process_logits, sample, step_seeds
from scalellm_tpu_torch.speculative.rejection_sampler import rejection_sample

# A round buffer's fields in order, each with its int32 words as a function
# of (S, MAXP, k). draft_ids: the n-gram round's proposals (the draft round
# leaves them 0).
ROUND_FIELDS = (
    ("first_tokens", lambda S, P, k: S),  # the last committed token of each sequence
    ("positions0", lambda S, P, k: S),  # its position
    ("slot_ids", lambda S, P, k: S * (k + 1)),  # KV slots of positions p0 .. p0 + k
    ("block_tables", lambda S, P, k: S * P),
    ("seq_mask", lambda S, P, k: S),
    ("num_seqs", lambda S, P, k: 1),
    ("temperatures", lambda S, P, k: S),
    ("top_ks", lambda S, P, k: S),
    ("top_ps", lambda S, P, k: S),
    ("seeds", lambda S, P, k: S),
    ("draft_ids", lambda S, P, k: S * k),
)
_F32_FIELDS = ("seq_mask", "temperatures", "top_ps")
# The profiler ranges of a draft round's three stages (host annotations: an
# eager round's kernels are attributed to them; a replay records none).
RANGES = ("spec_round.draft", "spec_round.verify", "spec_round.sampler")
_SHAPES = {"slot_ids": lambda S, P, k: (S, k + 1), "block_tables": lambda S, P, k: (S, P),
           "draft_ids": lambda S, P, k: (S, k)}


def round_words(S: int, MAXP: int, k: int) -> int:
    return sum(n(S, MAXP, k) for _, n in ROUND_FIELDS)


def pack_round(arrays: Dict[str, np.ndarray], S: int, MAXP: int, k: int) -> np.ndarray:
    """The round's host arrays as one flat int32 array (absent fields:
    zeros)."""
    out = np.zeros(round_words(S, MAXP, k), np.int32)
    off = 0
    for name, n in ROUND_FIELDS:
        w = n(S, MAXP, k)
        if name in arrays:
            a = np.ascontiguousarray(arrays[name]).reshape(-1)
            if a.size != w:
                raise ValueError(f"{name} has {a.size} entries, a round of S={S} MAXP={MAXP} k={k} takes {w}")
            out[off : off + w] = a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a
        off += w
    return out


def round_views(buf: torch.Tensor, S: int, MAXP: int, k: int) -> Dict[str, torch.Tensor]:
    """The round's fields: views of the flat device buffer."""
    out, off = {}, 0
    for name, n in ROUND_FIELDS:
        w = n(S, MAXP, k)
        t = buf[off : off + w]
        if name in _F32_FIELDS:
            t = t.view(torch.float32)
        if name in _SHAPES:
            t = t.view(*_SHAPES[name](S, MAXP, k))
        out[name] = t
        off += w
    return out


def round_arrays(seqs, k: int, step_counter: int, proposals=None) -> Tuple[Dict[str, np.ndarray], int, int]:
    """The padded host arrays of a round over `seqs` (each with its last
    token's KV not yet written, and KV slots reserved through position
    n + k - 1): (arrays, S, MAXP). Seeds: (base seed * 1000003 + the
    engine's step counter) mod 2^32, the base seed the request's or the
    sequence id, as the reference seeds a round. Penalties are left out of
    the round's distributions, as the reference leaves them. proposals: the
    n-gram round's k proposed ids a sequence."""
    S_real = len(seqs)
    S = pick_bucket(SEQ_BUCKETS, S_real)
    MAXP = pick_bucket(PAGE_BUCKETS, max(len(seq.blocks) for seq in seqs))
    a = dict(
        first_tokens=np.zeros(S, np.int32), positions0=np.zeros(S, np.int32),
        slot_ids=np.zeros((S, k + 1), np.int32), block_tables=np.zeros((S, MAXP), np.int32),
        seq_mask=np.zeros(S, np.float32), num_seqs=np.array([S_real], np.int32),
        temperatures=np.zeros(S, np.float32), top_ks=np.zeros(S, np.int32), top_ps=np.ones(S, np.float32),
        seeds=np.zeros(S, np.uint32))
    if proposals is not None:
        a["draft_ids"] = np.zeros((S, k), np.int32)
    for s, seq in enumerate(seqs):
        n = seq.num_tokens
        a["first_tokens"][s] = seq.token_ids[n - 1]
        a["positions0"][s] = n - 1
        a["slot_ids"][s] = seq.kv_slots_array(n - 1, n + k)
        bids = seq.block_ids_array()
        a["block_tables"][s, : len(bids)] = bids
        a["seq_mask"][s] = 1.0
        sp = seq.sampling_params
        a["temperatures"][s] = sp.temperature
        a["top_ks"][s] = sp.top_k if sp.top_k > 0 else 0
        a["top_ps"][s] = sp.top_p
        base_seed = sp.seed if sp.seed is not None else seq.seq_id
        a["seeds"][s] = np.uint32((base_seed * 1000003 + step_counter) & 0xFFFFFFFF)
        if proposals is not None:
            a["draft_ids"][s] = proposals[s]
    return a, S, MAXP


def round_plan(arrays: Dict[str, np.ndarray]) -> SamplingPlan:
    """The sampler stages a round runs: temperature and top-k/top-p where a
    row asks for them (no bias, penalty or mask stage)."""
    t, ks, ps = arrays["temperatures"], arrays["top_ks"], arrays["top_ps"]
    return SamplingPlan(bias=False, penalties=False, repetition=False, allowed_mask=False,
                        temperature=bool((t > 0.0).any()), top_k_top_p=bool((ks > 0).any() | (ps < 1.0).any()))


def round_sampling(v: Dict[str, torch.Tensor]) -> SamplingInputs:
    """The sampler's per-row inputs of a round, views of its buffer (the
    stages a round never runs read nothing)."""
    return SamplingInputs(
        temperatures=v["temperatures"], top_ks=v["top_ks"], top_ps=v["top_ps"], frequency_penalties=None,
        presence_penalties=None, repetition_penalties=None, unique_token_ids=None, unique_token_counts=None,
        bias_token_ids=None, bias_values=None, allowed_mask=None, seeds=v["seeds"])


def _cu1(v: Dict[str, torch.Tensor], S: int) -> torch.Tensor:
    """[S+1] cumulative lengths of one token a sequence, stopping at
    num_seqs (padding rows hold no tokens)."""
    return torch.minimum(torch.arange(S + 1, dtype=torch.int32, device=v["num_seqs"].device), v["num_seqs"])


def verify_probs(target, v: Dict[str, torch.Tensor], d_ids: torch.Tensor, si: SamplingInputs,
                 plan: SamplingPlan, S: int, k: int) -> torch.Tensor:
    """The target's forward over each sequence's k+1-token window (its last
    committed token, then the k proposals), every row's logits processed
    under the round's plan and softmaxed: [S, k+1, V] f32. The window's KV
    is written to slot_ids."""
    dev = d_ids.device
    tok = torch.cat([v["first_tokens"][:, None], d_ids.to(torch.int32)], dim=1).reshape(-1)
    steps = torch.arange(k + 1, dtype=torch.int32, device=dev)
    seg = torch.arange(S, dtype=torch.int32, device=dev)
    valid = (v["seq_mask"] > 0).to(torch.int32)
    mi = ModelInputs(
        token_ids=tok, positions=(v["positions0"][:, None] + steps).reshape(-1),
        token_seg=torch.repeat_interleave(seg, k + 1), new_kv_slot_ids=v["slot_ids"].reshape(-1),
        block_tables=v["block_tables"], kv_lens=(v["positions0"] + (k + 1)) * valid,
        cu_q_lens=_cu1(v, S) * (k + 1), num_seqs=v["num_seqs"],
        selected_idxes=torch.arange(S * (k + 1), dtype=torch.int32, device=dev), seq_mask=v["seq_mask"])
    hidden = target.model(target.kv_cache, mi, all_hidden=True)
    logits = target.model.logits(hidden)  # [S (k+1), V] f32
    si_rep = dataclasses.replace(si, **{
        name: torch.repeat_interleave(getattr(si, name), k + 1, dim=0)
        for name in ("temperatures", "top_ks", "top_ps")})
    return torch.softmax(process_logits(logits, si_rep, plan).reshape(S, k + 1, -1), dim=-1)


class RoundRunner:
    """What both kinds of round share: the round's key and its run, through
    the target executor's StepGraphs with graphs on, eagerly without."""

    kind = ""

    def __init__(self, target_executor, k: int):
        self.target = target_executor
        self.k = k

    def _round(self, v: Dict[str, torch.Tensor], plan: SamplingPlan, S: int) -> torch.Tensor:
        raise NotImplementedError

    def key(self, S: int, MAXP: int, plan: SamplingPlan) -> tuple:
        return (self.kind, S, MAXP, self.k, plan)

    @torch.inference_mode()
    def run(self, arrays: Dict[str, np.ndarray], S: int, MAXP: int) -> np.ndarray:
        """One round of the padded host arrays; returns its output [S,
        2k+1] (accepted ids, then the draft ids) as numpy, read once."""
        if self.target.kv_cache is None:
            raise RuntimeError("init_kv_cache first")
        k, plan = self.k, round_plan(arrays)
        words = pack_round(arrays, S, MAXP, k)

        def fn(buf: torch.Tensor) -> torch.Tensor:
            return self._round(round_views(buf, S, MAXP, k), plan, S)

        graphs = self.target.graphs
        if graphs is not None:
            out = graphs.run_round(self.key(S, MAXP, plan), words, fn)
        else:
            out = fn(torch.from_numpy(words).to(self.target.device))
        return out.cpu().numpy()


class SpecExecutor(RoundRunner):
    """The draft-model round: k draft steps, the target's verify forward
    and rejection_sample. Both executors keep their models and KV caches;
    the round writes both caches in place."""

    kind = "draft_round"

    def __init__(self, target_executor, draft_executor, k: int):
        super().__init__(target_executor, k)
        self.draft = draft_executor

    def _round(self, v: Dict[str, torch.Tensor], plan: SamplingPlan, S: int) -> torch.Tensor:
        k = self.k
        dev = v["first_tokens"].device
        seg = torch.arange(S, dtype=torch.int32, device=dev)
        cu1 = _cu1(v, S)
        valid = (v["seq_mask"] > 0).to(torch.int32)
        si = round_sampling(v)
        tokens = v["first_tokens"]
        ids: List[torch.Tensor] = []
        probs: List[torch.Tensor] = []
        with record_function(RANGES[0]):
            for i in range(k):
                mi = ModelInputs(
                    token_ids=tokens, positions=v["positions0"] + i, token_seg=seg,
                    new_kv_slot_ids=v["slot_ids"][:, i].contiguous(), block_tables=v["block_tables"],
                    kv_lens=(v["positions0"] + (i + 1)) * valid, cu_q_lens=cu1, num_seqs=v["num_seqs"],
                    selected_idxes=seg, seq_mask=v["seq_mask"])
                processed = process_logits(self.draft._forward(mi, True), si, plan)
                probs.append(torch.softmax(processed, dim=-1))
                if plan.temperature:
                    nt = sample(processed, si.temperatures, step_seeds(si.seeds, i + 1))
                else:
                    nt = sample(processed, None, None)
                tokens = nt.to(torch.int32)
                ids.append(tokens)
            d_ids = torch.stack(ids, dim=1)  # [S, k]
        with record_function(RANGES[1]):
            t_probs = verify_probs(self.target, v, d_ids, si, plan, S, k)
        with record_function(RANGES[2]):
            accepted = rejection_sample(d_ids, torch.stack(probs, dim=1), t_probs, v["temperatures"] > 0.0,
                                        si.seeds)
            return torch.cat([accepted, d_ids], dim=1)

    def execute(self, arrays: Dict[str, np.ndarray], S: int, MAXP: int) -> Tuple[np.ndarray, np.ndarray]:
        """(accepted [S, k+1], draft ids [S, k]) of one round, numpy."""
        out = self.run(arrays, S, MAXP)
        return out[:, : self.k + 1], out[:, self.k + 1 :]
