"""Engine-level model I/O structs (counterpart of scalellm_tpu/engine/params.py).

The batch builds them from numpy arrays padded to the bucket ladders of
engine/batch.py; to(device) turns every field into a tensor on the device.
StepInputs keeps the ModelInputs of every bucket in one device buffer that
a captured step program reads (engine/executor.py).

Shapes:
  T    — padded total new tokens this step (flattened across sequences)
  S    — padded number of sequences
  MAXP — padded max pages (KV blocks) per sequence
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def _to(obj, device):
    """Copy of a dataclass with every array or tensor field as a tensor on
    `device`."""
    changes = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, torch.Tensor):
            changes[f.name] = x.to(device, non_blocking=True)
        elif isinstance(x, np.ndarray):
            if x.dtype == np.uint32:  # torch has no general uint32 support
                x = x.astype(np.int64)
            changes[f.name] = torch.from_numpy(np.ascontiguousarray(x)).to(
                device, non_blocking=True
            )
    return dataclasses.replace(obj, **changes)


@dataclass
class ModelInputs:
    # [T] new token ids (padding: 0)
    token_ids: torch.Tensor
    # [T] position of each token within its sequence (padding: 0)
    positions: torch.Tensor
    # [T] index of the owning sequence (padding: 0 — outputs are discarded)
    token_seg: torch.Tensor
    # [T] global KV slot each new token writes to (padding: 0 = reserved block)
    new_kv_slot_ids: torch.Tensor
    # [S, MAXP] block/page table per sequence (padding: 0)
    block_tables: torch.Tensor
    # [S] total kv length per sequence incl. this step's tokens (padding: 0)
    kv_lens: torch.Tensor
    # [S+1] cumulative q-chunk lengths over the flattened [T] dim; rows past
    # the real sequences repeat the last value
    cu_q_lens: torch.Tensor
    # i32[1] number of real sequences
    num_seqs: torch.Tensor
    # [S] index into [T] of each sequence's last token (logit selection)
    selected_idxes: torch.Tensor
    # [S] 1.0 for real sequences, 0.0 for padding
    seq_mask: torch.Tensor
    # [S] LoRA adapter slot per sequence (0 = the base model; padding: 0);
    # set by the engine when adapters are loaded, else None (the step
    # buffer then holds zeros)
    lora_ids: "torch.Tensor | None" = None

    def to(self, device) -> "ModelInputs":
        return _to(self, device)


@dataclass
class SamplingInputs:
    # [S]
    temperatures: torch.Tensor
    top_ks: torch.Tensor
    top_ps: torch.Tensor
    frequency_penalties: torch.Tensor
    presence_penalties: torch.Tensor
    repetition_penalties: torch.Tensor
    # [S, U] unique token ids seen per sequence + counts (padding id: 0 with
    # count 0)
    unique_token_ids: torch.Tensor
    unique_token_counts: torch.Tensor
    # [S, B] additive logit bias entries (padding: id 0 with bias 0.0)
    bias_token_ids: torch.Tensor
    bias_values: torch.Tensor
    # [S, W] packed allowed-token bitmask (token v -> word v>>5, bit v&31);
    # W == 1 means no constraint this step
    allowed_mask: torch.Tensor
    # [S] per-step sampling seed per sequence
    seeds: torch.Tensor

    def to(self, device) -> "SamplingInputs":
        return _to(self, device)


@dataclass
class ModelOutputs:
    # [S] sampled next token per sequence
    next_tokens: torch.Tensor
    # [S] logprob of the sampled token
    logprobs: torch.Tensor
    # [S, K] top-k alternative ids/logprobs (K = 0 when top logprobs are off)
    top_ids: torch.Tensor
    top_logprobs: torch.Tensor


# ModelInputs' fields in the order StepInputs lays them out, each with its
# length as a function of the bucket (T, S, MAXP); seq_mask (f32) is kept as
# its bits. lora_ids is always there (zeros without adapters), so every step
# graph, the N-step ones included, reads the step's adapter slots on replay.
MODEL_FIELDS = (
    ("token_ids", lambda T, S, P: T),
    ("positions", lambda T, S, P: T),
    ("token_seg", lambda T, S, P: T),
    ("new_kv_slot_ids", lambda T, S, P: T),
    ("block_tables", lambda T, S, P: S * P),
    ("kv_lens", lambda T, S, P: S),
    ("cu_q_lens", lambda T, S, P: S + 1),
    ("num_seqs", lambda T, S, P: 1),
    ("selected_idxes", lambda T, S, P: S),
    ("seq_mask", lambda T, S, P: S),
    ("lora_ids", lambda T, S, P: S),
)
# What a step reads beside ModelInputs, after it: the pending-token merge of
# async stepping (a row's mask, 1 where the token is the previous step's
# sample, and its row in that step's outputs), and the sampler's per-row
# inputs that a multi-step graph reads on every replay (f32 fields as their
# bits, the uint32 seeds as int32).
EXTRA_FIELDS = (
    ("pending_mask", lambda T, S, P: T),
    ("pending_gather", lambda T, S, P: T),
    ("temperatures", lambda T, S, P: S),
    ("top_ks", lambda T, S, P: S),
    ("top_ps", lambda T, S, P: S),
    ("seeds", lambda T, S, P: S),
)
STEP_FIELDS = MODEL_FIELDS + EXTRA_FIELDS
_F32_FIELDS = ("seq_mask", "temperatures", "top_ps")


def step_words(T: int, S: int, MAXP: int) -> int:
    """int32 words of one bucket's fields in StepInputs' layout."""
    return sum(n(T, S, MAXP) for _, n in STEP_FIELDS)


class StepInputs:
    """Every field a step reads, in one flat int32 device buffer sized once
    for the largest bucket and never reallocated (a captured step program
    keeps its pointers). A bucket (T, S, MAXP) reads contiguous views of its
    front, in STEP_FIELDS order; `fill` writes a step's padded arrays,
    padding included, into a host staging buffer (pinned on a CUDA device)
    and sends them with one copy. Two staging buffers take turns, each
    reused only once its last copy is done, so that filling the next step
    while one is in flight never waits for the device."""

    def __init__(self, words: int, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.buffer = torch.zeros(words, dtype=torch.int32, device=self.device)
        self._staging = [torch.zeros(words, dtype=torch.int32, pin_memory=cuda) for _ in range(2)]
        # The last copy out of each staging buffer, waited for before a fill
        # overwrites it.
        self._sent = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._turn = 0

    def _words(self, T: int, S: int, MAXP: int) -> int:
        words = step_words(T, S, MAXP)
        if words > self.buffer.numel():
            raise ValueError(f"bucket T={T} S={S} MAXP={MAXP} exceeds the step buffer of "
                             f"{self.buffer.numel()} words (the serving envelope)")
        return words

    def _all_views(self, T: int, S: int, MAXP: int) -> dict:
        self._words(T, S, MAXP)
        out, off = {}, 0
        for name, n in STEP_FIELDS:
            k = n(T, S, MAXP)
            out[name] = self.buffer[off : off + k]
            if name in _F32_FIELDS:
                out[name] = out[name].view(torch.float32)
            off += k
        out["block_tables"] = out["block_tables"].view(S, MAXP)
        return out

    def views(self, T: int, S: int, MAXP: int) -> ModelInputs:
        """The bucket's ModelInputs: views of the device buffer."""
        out = self._all_views(T, S, MAXP)
        return ModelInputs(**{name: out[name] for name, _ in MODEL_FIELDS})

    def extra_views(self, T: int, S: int, MAXP: int) -> dict:
        """The bucket's EXTRA_FIELDS, by name: views of the device buffer."""
        out = self._all_views(T, S, MAXP)
        return {name: out[name] for name, _ in EXTRA_FIELDS}

    def fill(self, mi: ModelInputs, si: "SamplingInputs | None" = None,
             pending: "tuple | None" = None) -> None:
        """Write the padded numpy arrays of one step into the buffer's
        front with one host-to-device copy: `mi` (lora_ids zeros where it is
        None), the per-row sampler inputs of `si` (zeros without it:
        greedy), and the pending-token merge's (mask [T] bool, gather [T]
        int32) (zeros without it)."""
        T, (S, MAXP) = mi.token_ids.shape[0], mi.block_tables.shape
        words = self._words(T, S, MAXP)
        turn = self._turn
        self._turn ^= 1
        if self._sent[turn] is not None:
            self._sent[turn].synchronize()
        host = self._staging[turn].numpy()
        arrays = {name: getattr(mi, name) for name, _ in MODEL_FIELDS if getattr(mi, name) is not None}
        if pending is not None:
            arrays["pending_mask"], arrays["pending_gather"] = pending
        if si is not None:
            arrays.update({name: getattr(si, name) for name in ("temperatures", "top_ks", "top_ps", "seeds")})
        off = 0
        for name, n in STEP_FIELDS:
            k = n(T, S, MAXP)
            if name not in arrays:
                host[off : off + k] = 0
            else:
                a = np.asarray(arrays[name])
                if a.size != k:
                    raise ValueError(f"{name} has {a.size} entries, bucket T={T} S={S} MAXP={MAXP} takes {k}")
                a = a.reshape(-1)
                host[off : off + k] = a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a
            off += k
        self.buffer[:words].copy_(self._staging[turn][:words], non_blocking=True)
        if self._sent[turn] is not None:
            self._sent[turn].record()
