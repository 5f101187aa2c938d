"""Batched logits processing and token sampling
(counterpart of scalellm_tpu/sampling/sampler.py).

Per-sequence parameters arrive as tensors (SamplingInputs), so one call
serves any mix of greedy and random sequences. Order of operations:
logit bias -> frequency/presence penalties -> repetition penalty -> allowed
mask -> temperature -> top-k/top-p -> sample (greedy or Gumbel-max) ->
logprobs of the processed distribution.

Random rows draw their Gumbel noise from a torch.Generator seeded with the
row's per-step seed, on the logits' device; the draws differ from the JAX
package's (another generator), so tests compare distributions.

Which stages run, which rows sample and their seeds are decided on the host
(SamplingPlan, from the step's host arrays), so the sampler reads nothing
back from the device. A stage that no row asks for is skipped: it would
leave every logit as it is (a bias of 0, penalties of 0 and 1, an all-ones
mask, T <= 0, no top-k or top-p).
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


def gumbel_noise(seed: int, n: int, device) -> torch.Tensor:
    """[n] standard Gumbel noise from a generator seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    e = -torch.log(u.clamp_min(tiny))  # standard exponential
    return -torch.log(e.clamp_min(tiny))


def sample(
    logits: torch.Tensor,  # [S, V] processed logits (f32)
    rows: Tuple[int, ...],  # the rows that sample, from the host
    seeds: Tuple[int, ...],  # their per-step seeds, from the host
) -> torch.Tensor:
    """Greedy argmax, or Gumbel-max categorical for rows that sample. The
    greedy rows' noise is 0, which leaves their logits as they are."""
    if not rows:
        return torch.argmax(logits, dim=-1)
    noise = torch.zeros_like(logits)
    for r, seed in zip(rows, seeds):
        noise[r] = gumbel_noise(seed, logits.shape[-1], logits.device)
    return torch.argmax(logits + noise, dim=-1)


@dataclass(frozen=True)
class SamplingPlan:
    """The sampler's decisions for one step, taken on the host: which
    processing stages some row needs, and which rows sample with which
    seeds."""

    bias: bool
    penalties: bool
    repetition: bool
    allowed_mask: bool
    temperature: bool
    top_k_top_p: bool
    sample_rows: Tuple[int, ...]
    sample_seeds: Tuple[int, ...]

    @classmethod
    def of(cls, si: SamplingInputs) -> "SamplingPlan":
        """The plan of host SamplingInputs (numpy arrays or CPU tensors)."""
        a = {name: np.asarray(getattr(si, name)) for name in (
            "bias_values", "frequency_penalties", "presence_penalties", "repetition_penalties",
            "allowed_mask", "temperatures", "top_ks", "top_ps", "seeds")}
        rows = np.flatnonzero(a["temperatures"] > 0.0)
        return cls(
            bias=bool((a["bias_values"] != 0.0).any()),
            penalties=bool((a["frequency_penalties"] != 0.0).any() | (a["presence_penalties"] != 0.0).any()),
            repetition=bool((a["repetition_penalties"] != 1.0).any()),
            allowed_mask=a["allowed_mask"].shape[1] > 1,
            temperature=rows.size > 0,
            top_k_top_p=bool((a["top_ks"] > 0).any() | (a["top_ps"] < 1.0).any()),
            sample_rows=tuple(int(r) for r in rows),
            sample_seeds=tuple(int(s) for s in a["seeds"][rows]),
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
    next_tokens = sample(processed, plan.sample_rows, plan.sample_seeds)
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
