"""Batched logits processing and token sampling
(counterpart of scalellm_tpu/sampling/sampler.py).

Per-sequence parameters arrive as tensors (SamplingInputs), so one call
serves any mix of greedy and random sequences. Order of operations:
logit bias -> frequency/presence penalties -> repetition penalty -> allowed
mask -> temperature -> top-k/top-p -> sample (greedy or Gumbel-max) ->
logprobs of the processed distribution.

Random rows draw their Gumbel noise from a counter-based hash of (the row's
uint32 seed, the vocabulary index), computed with integer tensor ops from
the seeds on the logits' device: the port's counterpart of the reference's
fold_in(PRNGKey(0), seed). Nothing is seeded from the host, so a captured
CUDA graph draws anew on every replay from the seeds its step buffer holds
(engine/executor.py), and the eager and replayed draws are the same. The
draws differ from the JAX package's (another generator), so tests compare
distributions.

Which stages run is decided on the host (SamplingPlan, from the step's host
arrays), so the sampler reads nothing back from the device. A stage that no
row asks for is skipped: it would leave every logit as it is (a bias of 0,
penalties of 0 and 1, an all-ones mask, T <= 0, no top-k or top-p).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from scalellm_tpu_torch.engine.params import ModelOutputs, SamplingInputs

_NEG_INF = -1e30


def apply_frequency_presence_penalties(
    logits: torch.Tensor,  # [S, V] f32
    unique_ids: torch.Tensor,  # [S, U] (pad id 0 with count 0)
    unique_counts: torch.Tensor,  # [S, U]
    frequency_penalties: torch.Tensor,  # [S]
    presence_penalties: torch.Tensor,  # [S]
) -> torch.Tensor:
    """logits[s, t] -= count[t] * freq_p[s] + (count[t] > 0) * presence_p[s]."""
    adj = (
        unique_counts.float() * frequency_penalties[:, None]
        + (unique_counts > 0).float() * presence_penalties[:, None]
    )
    return logits.scatter_add(1, unique_ids.long(), -adj)


def apply_repetition_penalty(
    logits: torch.Tensor,  # [S, V] f32
    unique_ids: torch.Tensor,  # [S, U]
    unique_counts: torch.Tensor,  # [S, U]
    repetition_penalties: torch.Tensor,  # [S]
) -> torch.Tensor:
    """Divide positive / multiply negative logits of seen tokens by p."""
    ids = unique_ids.long()
    vals = logits.gather(1, ids)
    p = repetition_penalties[:, None]
    penalized = torch.where(vals > 0, vals / p, vals * p)
    # Padding entries (count 0) share id 0: they write to a spare column past
    # V, which is dropped, so no duplicate-index write can clobber token 0
    # (and no boolean mask reads a count back to the host).
    V = logits.shape[-1]
    ids = torch.where(unique_counts > 0, ids, V)
    out = torch.cat([logits, logits[:, :1]], dim=1).scatter(1, ids, penalized)
    return out[:, :V].contiguous()


def apply_logit_bias(
    logits: torch.Tensor,  # [S, V] f32
    bias_ids: torch.Tensor,  # [S, B] (pad id 0 with bias 0)
    bias_values: torch.Tensor,  # [S, B] f32
) -> torch.Tensor:
    """Additive per-token bias; padding entries add 0 to token 0."""
    return logits.scatter_add(1, bias_ids.long(), bias_values.float())


def apply_allowed_mask(
    logits: torch.Tensor,  # [S, V] f32
    allowed_mask: torch.Tensor,  # [S, W] packed bits (token v: word v>>5, bit v&31)
) -> torch.Tensor:
    """Tokens with a 0 bit get -1e30; ids past the mask are banned."""
    V = logits.shape[-1]
    W = allowed_mask.shape[1]
    v = torch.arange(V, device=logits.device)
    words = allowed_mask.long()[:, torch.clamp(v >> 5, max=W - 1)]  # [S, V]
    bits = (words >> (v & 31)) & 1
    bits = torch.where(v < W * 32, bits, torch.zeros_like(bits))
    return torch.where(bits == 1, logits, torch.full_like(logits, _NEG_INF))


def apply_temperature(logits: torch.Tensor, temperatures: torch.Tensor) -> torch.Tensor:
    """Scale by 1/T; T == 0 (greedy) passes through unscaled."""
    t = torch.where(temperatures <= 0.0, torch.ones_like(temperatures), temperatures)
    return logits / t[:, None]


def apply_top_k_top_p(
    logits: torch.Tensor,  # [S, V] f32
    top_ks: torch.Tensor,  # [S], <= 0 disables
    top_ps: torch.Tensor,  # [S], >= 1 disables
) -> torch.Tensor:
    """Mask logits outside top-k / top-p, jointly in one sorted pass."""
    S, V = logits.shape
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    ranks = torch.arange(V, device=logits.device)[None, :]
    k = torch.where(top_ks <= 0, torch.full_like(top_ks, V), top_ks.clamp(max=V)).long()
    kth_value = sorted_logits.gather(1, (k - 1)[:, None])
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    include = (cum - probs_sorted) < top_ps[:, None]
    last_rank = torch.where(include, ranks, torch.zeros_like(ranks)).amax(dim=-1, keepdim=True)
    pth_value = sorted_logits.gather(1, last_rank)
    thresh = torch.maximum(kth_value, pth_value)
    return torch.where(logits >= thresh, logits, torch.full_like(logits, _NEG_INF))


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (lowbias32: xor-shift, multiply, twice) on
    uint32 values held in int64. The products exceed 32 bits; their low 32
    bits are kept."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, V: int) -> torch.Tensor:
    """[S, V] standard Gumbel noise, row s a function of seeds[s] (uint32
    values, any integer dtype, on the device) alone: u = hash(seed, v) in
    (0, 1) from 24 bits of a hash of the vocabulary index keyed by the
    hashed seed, then -log(-log(u))."""
    key = _mix32((seeds.long() & _MASK32) ^ 0x9E3779B9)
    v = torch.arange(V, dtype=torch.int64, device=seeds.device)
    x = _mix32((_mix32(v[None, :] ^ key[:, None]) + key[:, None]) & _MASK32)
    u = ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def step_seeds(seeds: torch.Tensor, i: int) -> torch.Tensor:
    """Micro-step i's seeds: seeds + i * 2654435761 (mod 2^32), as the
    reference's multi-step program folds them, so that a sampling row does
    not repeat its draw."""
    return (seeds.long() + i * 2654435761) & _MASK32


def sample(
    logits: torch.Tensor,  # [S, V] processed logits (f32)
    temperatures: "torch.Tensor | None",  # [S]; rows with T > 0 sample
    seeds: "torch.Tensor | None",  # [S] per-step seeds (uint32 values)
) -> torch.Tensor:
    """Greedy argmax, or Gumbel-max categorical for rows with T > 0. The
    greedy rows' noise is 0, which leaves their logits as they are. With
    temperatures None (no row samples, SamplingPlan.temperature off) the
    step is greedy and reads neither tensor."""
    if temperatures is None:
        return torch.argmax(logits, dim=-1)
    noise = gumbel_noise(seeds, logits.shape[-1])
    noise = torch.where(temperatures[:, None] > 0.0, noise, torch.zeros_like(noise))
    return torch.argmax(logits + noise, dim=-1)


@dataclass(frozen=True)
class SamplingPlan:
    """The sampler's decisions for one step, taken on the host: which
    processing stages some row needs (temperature: some row samples), and
    the width of the per-row bias arrays. A captured multi-step graph bakes
    the stages in, so the plan is part of its key (a multi-step dispatch
    runs no penalty or mask stage, so the widths of the unique-token and
    mask arrays are 1 there)."""

    bias: bool
    penalties: bool
    repetition: bool
    allowed_mask: bool
    temperature: bool
    top_k_top_p: bool
    bias_width: int = 1

    @classmethod
    def of(cls, si: SamplingInputs) -> "SamplingPlan":
        """The plan of host SamplingInputs (numpy arrays or CPU tensors)."""
        a = {name: np.asarray(getattr(si, name)) for name in (
            "bias_values", "frequency_penalties", "presence_penalties", "repetition_penalties",
            "allowed_mask", "temperatures", "top_ks", "top_ps")}
        return cls(
            bias=bool((a["bias_values"] != 0.0).any()),
            penalties=bool((a["frequency_penalties"] != 0.0).any() | (a["presence_penalties"] != 0.0).any()),
            repetition=bool((a["repetition_penalties"] != 1.0).any()),
            allowed_mask=a["allowed_mask"].shape[1] > 1,
            temperature=bool((a["temperatures"] > 0.0).any()),
            top_k_top_p=bool((a["top_ks"] > 0).any() | (a["top_ps"] < 1.0).any()),
            bias_width=a["bias_values"].shape[1],
        )

    @property
    def reads_inputs(self) -> bool:
        """Whether a stage reads SamplingInputs on the device (a plain greedy
        step reads none)."""
        return (self.bias or self.penalties or self.repetition or self.allowed_mask
                or self.temperature or self.top_k_top_p)


def process_logits(logits: torch.Tensor, si: SamplingInputs, plan: "SamplingPlan | None" = None) -> torch.Tensor:
    """The full logits-processing pipeline, in the reference's order. plan
    defaults to the plan of si, which must then be on the host."""
    plan = plan or SamplingPlan.of(si)
    logits = logits.float()
    if plan.bias:
        logits = apply_logit_bias(logits, si.bias_token_ids, si.bias_values)
    if plan.penalties:
        logits = apply_frequency_presence_penalties(
            logits, si.unique_token_ids, si.unique_token_counts,
            si.frequency_penalties, si.presence_penalties,
        )
    if plan.repetition:
        logits = apply_repetition_penalty(
            logits, si.unique_token_ids, si.unique_token_counts,
            si.repetition_penalties,
        )
    if plan.allowed_mask:
        logits = apply_allowed_mask(logits, si.allowed_mask)
    if plan.temperature:
        logits = apply_temperature(logits, si.temperatures)
    if plan.top_k_top_p:
        logits = apply_top_k_top_p(logits, si.top_ks, si.top_ps)
    return logits


def sample_tokens(
    logits: torch.Tensor,  # [S, V] raw model logits
    si: SamplingInputs,
    max_top_logprobs: int = 0,
    plan: "SamplingPlan | None" = None,
) -> ModelOutputs:
    """Process, sample and take logprobs in one call. plan: the host
    decisions (SamplingPlan.of the host arrays); without it si must be on
    the host, and only stages it asks for read si."""
    plan = plan or SamplingPlan.of(si)
    processed = process_logits(logits, si, plan)
    if plan.temperature:
        next_tokens = sample(processed, si.temperatures, si.seeds)
    else:
        next_tokens = sample(processed, None, None)
    logprobs_all = torch.log_softmax(processed, dim=-1)
    chosen_lp = logprobs_all.gather(1, next_tokens[:, None]).squeeze(-1)
    if max_top_logprobs > 0:
        top_lp, top_ids = torch.topk(logprobs_all, max_top_logprobs, dim=-1)
    else:
        S = logits.shape[0]
        top_lp = torch.zeros((S, 0), dtype=torch.float32, device=logits.device)
        top_ids = torch.zeros((S, 0), dtype=torch.int64, device=logits.device)
    return ModelOutputs(
        next_tokens=next_tokens.int(),
        logprobs=chosen_lp,
        top_ids=top_ids.int(),
        top_logprobs=top_lp,
    )
