"""Engine-level model I/O structs (counterpart of scalellm_tpu/engine/params.py).

The batch builds them from numpy arrays padded to the bucket ladders of
engine/batch.py; to(device) turns every field into a tensor on the device.

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
    # [S] LoRA adapter slot per sequence; LoRA is not ported, always None
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
