"""Batched rejection sampling for speculative decoding
(counterpart of scalellm_tpu/speculative/rejection_sampler.py).

Given k draft tokens (with the draft's distributions, or one-hot proposals)
and the target model's k+1 distributions, produces each sequence's accepted
tokens [S, k+1], -1 after the first rejection:

  - position i < r (the first rejection): the accepted draft token
  - position r < k: a token drawn from normalize(max(p_target - p_draft, 0))
    (one-hot proposals: p_target with the proposed token zeroed)
  - position k (every draft accepted): a bonus token from the target's last
    distribution
  - greedy rows (do_sample false) accept iff draft == argmax(p_target), and
    their replacement and bonus are argmax(p_target)

The random draws (the acceptance uniforms, the recovery and bonus Gumbel
noise, tags 0, 1 and 2) are a counter-based hash of the row's uint32 seed,
the tag, the draft position and the vocabulary index, in integer tensor ops
on the device (sampling/sampler.py's _mix32 and gumbel_noise): nothing is
drawn from host state, so a captured round graph draws anew on every replay
from the seeds its inputs hold. The distribution is the reference's; the
tokens of a seed are not (another generator). Greedy rows are exact.
"""

from __future__ import annotations

import torch

from scalellm_tpu_torch.sampling.sampler import _MASK32, _mix32, gumbel_noise

_EPS = 1e-10


def tag_seeds(seeds: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    """[S, n] uint32 values (in int64): one seed for each row, draw `tag`
    and position j < n, a hash of (seeds[s], tag, j)."""
    key = _mix32((seeds.long() & _MASK32) ^ ((tag + 1) * 0x85EBCA6B & _MASK32))
    j = torch.arange(n, dtype=torch.int64, device=seeds.device)
    return _mix32((key[:, None] + (j + 1) * 0x9E3779B9) & _MASK32)


def uniform(seeds: torch.Tensor, tag: int, n: int) -> torch.Tensor:
    """[S, n] f32 uniforms in (0, 1) from 24 bits of tag_seeds."""
    x = _mix32(tag_seeds(seeds, tag, n))
    return ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _sample_rows(seeds: torch.Tensor, tag: int, probs: torch.Tensor, greedy_probs: torch.Tensor,
                 do_sample: torch.Tensor) -> torch.Tensor:
    """[S, n] draws: Gumbel-max over log(probs [S, n, V]) for sampling rows,
    argmax of greedy_probs for the others (the reference's greedy_sample
    takes the TARGET's argmax, not the residual's: anything else breaks
    greedy losslessness)."""
    S, n, V = probs.shape
    g = gumbel_noise(tag_seeds(seeds, tag, n).reshape(-1), V).reshape(S, n, V)
    rand = torch.argmax(torch.log(torch.clamp(probs, min=_EPS)) + g, dim=-1)
    greedy = torch.argmax(greedy_probs, dim=-1)
    return torch.where(do_sample[:, None], rand, greedy)


def _assemble(draft_ids: torch.Tensor, accepted: torch.Tensor, resampled: torch.Tensor,
              bonus: torch.Tensor) -> torch.Tensor:
    """[S, k+1]: draft ids before the first rejection r, the replacement
    (resampled[r] if r < k, else the bonus) at r, -1 after."""
    S, k = draft_ids.shape
    r = torch.cumprod(accepted.to(torch.int32), dim=-1).sum(-1)  # [S] in [0, k]
    pos = torch.arange(k + 1, dtype=torch.int64, device=draft_ids.device)[None, :]
    r_col = r[:, None].long()
    draft_padded = torch.cat([draft_ids.long(), torch.zeros_like(draft_ids[:, :1]).long()], dim=-1)
    replacement = torch.where(r < k, resampled.gather(1, torch.clamp(r_col, max=k - 1)).squeeze(1), bonus)
    out = torch.where(pos < r_col, draft_padded, torch.full_like(draft_padded, -1))
    out = torch.where(pos == r_col, replacement[:, None], out)
    return out.to(torch.int32)


def rejection_sample(
    draft_ids: torch.Tensor,  # i32[S, k]
    draft_probs: torch.Tensor,  # f32[S, k, V]
    target_probs: torch.Tensor,  # f32[S, k+1, V]
    do_sample: torch.Tensor,  # bool[S]
    seeds: torch.Tensor,  # [S] uint32 values (any integer dtype)
) -> torch.Tensor:
    """Returns the accepted token ids i32[S, k+1], -1 padded."""
    k = draft_ids.shape[1]
    p_tgt_k = target_probs[:, :k]
    idx = draft_ids.long()[..., None]
    p_t = p_tgt_k.gather(-1, idx).squeeze(-1)
    p_d = draft_probs.gather(-1, idx).squeeze(-1)
    u = uniform(seeds, 0, k)
    accept_random = u < p_t / torch.clamp(p_d, min=_EPS)
    accept_greedy = draft_ids.long() == torch.argmax(p_tgt_k, dim=-1)
    accepted = torch.where(do_sample[:, None], accept_random, accept_greedy)
    adjusted = torch.clamp(p_tgt_k - draft_probs, min=0.0)
    adjusted = adjusted / torch.clamp(adjusted.sum(-1, keepdim=True), min=_EPS)
    resampled = _sample_rows(seeds, 1, adjusted, p_tgt_k, do_sample)
    last = target_probs[:, k:]
    bonus = _sample_rows(seeds, 2, last, last, do_sample)[:, 0]
    return _assemble(draft_ids, accepted, resampled, bonus)


def rejection_sample_onehot(
    draft_ids: torch.Tensor,  # i32[S, k]
    target_probs: torch.Tensor,  # f32[S, k+1, V]
    do_sample: torch.Tensor,  # bool[S]
    seeds: torch.Tensor,  # [S] uint32 values
) -> torch.Tensor:
    """rejection_sample for deterministic proposals (prompt lookup): the
    draft distribution is one-hot at draft_ids, so a token is accepted with
    probability p_target(token) and the recovery distribution is p_target
    with the proposed token zeroed; no [S, k, V] one-hot is built."""
    k = draft_ids.shape[1]
    p_tgt_k = target_probs[:, :k]
    idx = draft_ids.long()[..., None]
    p_t = p_tgt_k.gather(-1, idx).squeeze(-1)
    u = uniform(seeds, 0, k)
    accept_random = u < p_t
    accept_greedy = draft_ids.long() == torch.argmax(p_tgt_k, dim=-1)
    accepted = torch.where(do_sample[:, None], accept_random, accept_greedy)
    zeroed = p_tgt_k.scatter(-1, idx, torch.zeros_like(p_t)[..., None])
    adjusted = zeroed / torch.clamp(zeroed.sum(-1, keepdim=True), min=_EPS)
    resampled = _sample_rows(seeds, 1, adjusted, p_tgt_k, do_sample)
    last = target_probs[:, k:]
    bonus = _sample_rows(seeds, 2, last, last, do_sample)[:, 0]
    return _assemble(draft_ids, accepted, resampled, bonus)
