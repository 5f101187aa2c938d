"""Executor — runs the per-step model program eagerly
(counterpart of scalellm_tpu/engine/executor.py, single device).

One step is forward -> logits -> sample_tokens, run under
torch.inference_mode. The paged KV cache is one persistent tensor
(model.kv_cache_shape: [L, P, page, 2*Hkv, Dh], or [L, P, page, 1, Dc] for
MLA's latent cache) that every step updates IN PLACE.
"""

from __future__ import annotations

import torch

from scalellm_tpu_torch.engine.params import ModelInputs, ModelOutputs, SamplingInputs
from scalellm_tpu_torch.sampling.sampler import sample_tokens


class Executor:
    """Owns the model (weights on the device) and the KV cache."""

    def __init__(self, model, device, max_top_logprobs: int = 0):
        self.model = model
        self.device = torch.device(device)
        self.max_top_logprobs = max_top_logprobs
        self.kv_cache = None

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

    @torch.inference_mode()
    def execute(self, mi: ModelInputs, si: SamplingInputs, decode_only: bool = False) -> ModelOutputs:
        """Run one step; the KV cache is updated in place. Outputs stay on
        the device. decode_only: every sequence has one token (MLA models
        take their decode kernel on such a step)."""
        if self.kv_cache is None:
            raise RuntimeError("init_kv_cache first")
        mi = mi.to(self.device)
        si = si.to(self.device)
        hidden = self.model(self.kv_cache, mi, decode_only=decode_only)
        logits = self.model.logits(hidden)
        return sample_tokens(logits, si, max_top_logprobs=self.max_top_logprobs)
