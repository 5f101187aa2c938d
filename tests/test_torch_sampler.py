"""The port's logits processing and sampling against the JAX package's
(scalellm_tpu/sampling/sampler.py). Processed logits and greedy picks must
match exactly; random draws come from another generator, so they are held
to the processed distribution by a chi-square test over a few thousand
draws (fixed seeds, so the test is deterministic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.engine.params import SamplingInputs as JaxSamplingInputs
from scalellm_tpu.sampling import sampler as jax_sampler
from scalellm_tpu_torch.engine.params import SamplingInputs
from scalellm_tpu_torch.sampling import sampler

# chi-square critical values at p = 0.001, by degrees of freedom
CHI2_999 = {2: 13.816, 3: 16.266, 5: 20.515, 7: 24.322}


def _si(S, V, **kw):
    a = dict(
        temperatures=np.zeros(S, np.float32),
        top_ks=np.zeros(S, np.int32),
        top_ps=np.ones(S, np.float32),
        frequency_penalties=np.zeros(S, np.float32),
        presence_penalties=np.zeros(S, np.float32),
        repetition_penalties=np.ones(S, np.float32),
        unique_token_ids=np.zeros((S, 4), np.int32),
        unique_token_counts=np.zeros((S, 4), np.int32),
        bias_token_ids=np.zeros((S, 4), np.int32),
        bias_values=np.zeros((S, 4), np.float32),
        allowed_mask=np.full((S, 1), 0xFFFFFFFF, np.uint32),
        seeds=np.arange(S, dtype=np.uint32),
    )
    a.update(kw)
    return (
        SamplingInputs(**a).to("cpu"),
        JaxSamplingInputs(**{k: jnp.asarray(v) for k, v in a.items()}),
    )


def _processing_cases(rng, S, V):
    ids = np.stack([rng.choice(V, 4, replace=False) for _ in range(S)]).astype(np.int32)
    counts = rng.integers(0, 3, (S, 4)).astype(np.int32)
    mask = np.full((S, (V + 31) // 32), 0xFFFFFFFF, np.uint32)
    mask[0, 0] = 0xFFFF0F0F
    return {
        "temperature": dict(temperatures=rng.uniform(0.3, 2.0, S).astype(np.float32)),
        "penalties": dict(
            unique_token_ids=ids, unique_token_counts=counts,
            frequency_penalties=np.full(S, 0.5, np.float32),
            presence_penalties=np.full(S, 0.25, np.float32),
            repetition_penalties=np.full(S, 1.3, np.float32),
        ),
        "logit_bias": dict(bias_token_ids=ids, bias_values=rng.uniform(-5, 5, (S, 4)).astype(np.float32)),
        "top_k_top_p": dict(
            temperatures=np.full(S, 0.8, np.float32),
            top_ks=np.array([0, 3, 10, 1, 50, 0], np.int32)[:S],
            top_ps=np.array([0.9, 1.0, 0.5, 0.7, 0.95, 0.3], np.float32)[:S],
        ),
        "allowed_mask": dict(allowed_mask=mask),
    }


@pytest.mark.parametrize(
    "case", ["temperature", "penalties", "logit_bias", "top_k_top_p", "allowed_mask"]
)
def test_processed_logits_and_greedy_match_jax_exactly(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    S, V = 6, 64
    logits = rng.standard_normal((S, V)).astype(np.float32) * 3
    si, jsi = _si(S, V, **_processing_cases(rng, S, V)[case])
    got = sampler.process_logits(torch.from_numpy(logits), si).numpy()
    want = np.asarray(jax_sampler.process_logits(jnp.asarray(logits), jsi))
    np.testing.assert_array_equal(got, want)

    # Greedy picks of the same batch (temperatures forced to 0).
    si0, jsi0 = _si(S, V, **dict(_processing_cases(rng, S, V)[case],
                                 temperatures=np.zeros(S, np.float32)))
    got = sampler.sample_tokens(torch.from_numpy(logits), si0, max_top_logprobs=3)
    want = jax_sampler.sample_tokens(jnp.asarray(logits), jsi0, max_top_logprobs=3)
    np.testing.assert_array_equal(got.next_tokens.numpy(), np.asarray(want.next_tokens))
    # Top ids agree where they are not ties among masked (-1e30) tokens.
    real = np.asarray(want.top_logprobs) > -1e20
    np.testing.assert_array_equal(got.top_ids.numpy()[real], np.asarray(want.top_ids)[real])
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs), atol=1e-6)


@pytest.mark.parametrize("top_k", [0, 4])
def test_random_draws_follow_the_processed_distribution(top_k):
    V, n = 8, 4000
    logits = np.linspace(-1.0, 1.5, V, dtype=np.float32)
    si, _ = _si(n, V, temperatures=np.full(n, 0.9, np.float32),
                top_ks=np.full(n, top_k, np.int32),
                seeds=np.arange(1000, 1000 + n, dtype=np.uint32))
    batch = torch.from_numpy(np.tile(logits, (n, 1)))
    draws = sampler.sample_tokens(batch, si).next_tokens.numpy()
    probs = torch.softmax(sampler.process_logits(batch[:1], _si(1, V, **{
        "temperatures": np.full(1, 0.9, np.float32),
        "top_ks": np.full(1, top_k, np.int32)})[0])[0], -1).numpy()
    support = probs > 0
    assert np.all(support[draws])  # nothing outside top-k
    observed = np.bincount(draws, minlength=V)[support]
    expected = probs[support] * n
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_999[int(support.sum()) - 1], (chi2, observed, expected)


def test_same_seed_same_draw():
    si, _ = _si(2, 16, temperatures=np.ones(2, np.float32),
                seeds=np.array([5, 5], np.uint32))
    logits = torch.zeros(2, 16)
    out = sampler.sample_tokens(logits, si).next_tokens
    assert out[0] == out[1]


# The device-seeded noise (sampler.gumbel_noise): a hash of (seed, vocabulary
# index) computed with integer tensor ops, so a replayed graph draws anew
# from the seeds in its step buffer.


@pytest.mark.parametrize("fold", ["seeds", "micro_steps"])
def test_device_seeded_draws_follow_softmax(fold):
    """Gumbel-max over 6000 draws at T = 0.7 follows the softmax: the
    chi-square statistic of the counts stays below its p = 0.001 critical
    value (5 degrees of freedom). "seeds": one row per consecutive seed;
    "micro_steps": one seed folded for micro-steps 0..5999
    (sampler.step_seeds), as a multi-step dispatch draws."""
    V, n = 6, 6000
    logits = np.array([0.3, -1.0, 1.2, 0.0, 0.8, -0.4], np.float32)
    if fold == "seeds":
        seeds = np.arange(77, 77 + n, dtype=np.uint32)
    else:
        seeds = np.stack([sampler.step_seeds(torch.tensor([4242]), i) for i in range(n)])[:, 0]
        seeds = seeds.astype(np.uint32)
    si, _ = _si(n, V, temperatures=np.full(n, 0.7, np.float32), seeds=seeds)
    draws = sampler.sample_tokens(torch.from_numpy(np.tile(logits, (n, 1))), si).next_tokens.numpy()
    probs = torch.softmax(torch.from_numpy(logits) / 0.7, -1).numpy()
    observed = np.bincount(draws, minlength=V)
    chi2 = float(((observed - probs * n) ** 2 / (probs * n)).sum())
    assert chi2 < CHI2_999[5], (chi2, observed, probs * n)


def test_device_noise_is_a_function_of_the_row_seed():
    """A row's noise depends on its own seed alone (not on its row or the
    batch), the same seed gives the same noise, and it is standard Gumbel
    (mean 0.5772, std pi / sqrt(6) within 2% over 64000 values)."""
    seeds = torch.tensor([3, 2**32 - 1, 12345, 3], dtype=torch.int64)
    g = sampler.gumbel_noise(seeds, 16000)
    assert torch.equal(g[0], g[3]) and not torch.equal(g[0], g[2])
    assert torch.equal(sampler.gumbel_noise(seeds[1:2], 16000)[0], g[1])
    # uint32 seeds held as int32 bits (the step buffer) give the same noise.
    assert torch.equal(sampler.gumbel_noise(seeds.to(torch.int32), 16000), g)
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.02 and abs(g.std().item() - np.pi / 6**0.5) < 0.03


def test_greedy_rows_are_untouched_by_sampling_rows():
    """In a batch that mixes greedy and sampling rows, the greedy rows pick
    argmax and keep the logprobs of an all-greedy batch, bit for bit."""
    rng = np.random.default_rng(3)
    S, V = 6, 40
    logits = torch.from_numpy(rng.standard_normal((S, V)).astype(np.float32) * 2)
    temps = np.array([0.0, 0.9, 0.0, 1.3, 0.0, 0.5], np.float32)
    mixed, _ = _si(S, V, temperatures=temps, seeds=np.arange(S, dtype=np.uint32) + 9)
    greedy, _ = _si(S, V)
    got = sampler.sample_tokens(logits, mixed, max_top_logprobs=2)
    want = sampler.sample_tokens(logits, greedy, max_top_logprobs=2)
    rows = temps == 0.0
    assert torch.equal(got.next_tokens[rows], logits.argmax(-1).int()[rows])
    assert torch.equal(got.logprobs[rows], want.logprobs[rows])
