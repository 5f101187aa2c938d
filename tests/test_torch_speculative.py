"""The port's speculative decoding (scalellm_tpu_torch/speculative/) against
the JAX package's, on the CPU:

- rejection_sample and rejection_sample_onehot: greedy rows give the JAX
  sampler's ids exactly (sampled rows beside them in the batch); sampled
  rows on deterministic edge cases (draft equal to target: every draft and
  the bonus kept; target zero at the draft token: rejected at 0 and redrawn
  from the residual); a chi-square test that the first emitted token follows
  the target distribution (the draws are the port's own hash of the seeds,
  not jax.random's, so only distributions are compared);
- propose_ngram equal to the reference's on seeded and hypothesis-drawn
  lists;
- LLM with a draft model (the tiny fixture as its own draft, and a second
  tiny model) and with prompt lookup: greedy ids equal to the port's plain
  serve and to scalellm_tpu.LLM's with the same options, with chunked
  prefill, four concurrent requests, graphs on and off, and the counters;
  the irregular-lag fallback; sampled speculation repeatable from its
  seeds; the refusals (LoRA with speculation, a draft of another vocab);
- the draft latency histogram: as many samples as the reference's for the
  same traffic (no sample for a catch-up step).
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.torch_port_util import generate_within, tiny_llama

PROMPTS = ["hello world", "abc", "the quick brown fox jumps over", "hello world, hello world"]


@pytest.fixture(scope="module")
def tiny_model():
    return tiny_llama()


def _probs(rng, *shape):
    p = rng.random(shape).astype(np.float32) ** 3
    return p / p.sum(-1, keepdims=True)


def _port_sample(onehot, draft_ids, draft_probs, target, do_sample, seeds):
    import torch

    from scalellm_tpu_torch.speculative.rejection_sampler import rejection_sample, rejection_sample_onehot

    args = (torch.from_numpy(draft_ids),)
    if not onehot:
        args += (torch.from_numpy(draft_probs),)
    args += (torch.from_numpy(target), torch.from_numpy(do_sample), torch.from_numpy(seeds.astype(np.int64)))
    fn = rejection_sample_onehot if onehot else rejection_sample
    return fn(*args).numpy()


def _jax_sample(onehot, draft_ids, draft_probs, target, do_sample, seeds):
    from scalellm_tpu.speculative.rejection_sampler import rejection_sample, rejection_sample_onehot

    if onehot:
        return np.asarray(rejection_sample_onehot(draft_ids, target, do_sample, seeds))
    return np.asarray(rejection_sample(draft_ids, draft_probs, target, do_sample, seeds))


@pytest.mark.parametrize("onehot", [False, True])
def test_greedy_rows_match_jax_exactly(onehot):
    S, k, V = 24, 4, 50
    rng = np.random.default_rng(0)
    target = _probs(rng, S, k + 1, V)
    draft_probs = _probs(rng, S, k, V)
    # Drafts that follow the target's argmax up to a row-dependent position,
    # so that every first-rejection index 0..k occurs.
    draft_ids = target[:, :k].argmax(-1).astype(np.int32)
    for s in range(S):
        r = s % (k + 1)
        if r < k:
            draft_ids[s, r] = (draft_ids[s, r] + 1 + s) % V
    do_sample = (np.arange(S) % 3 == 2)  # sampled rows beside the greedy ones
    seeds = rng.integers(0, 2**32, S, dtype=np.uint64).astype(np.uint32)
    got = _port_sample(onehot, draft_ids, draft_probs, target, do_sample, seeds)
    want = _jax_sample(onehot, draft_ids, draft_probs, target, do_sample, seeds)
    assert got.dtype == np.int32 and got.shape == (S, k + 1)
    np.testing.assert_array_equal(got[~do_sample], want[~do_sample])
    # Every row: a prefix of drafts, one replacement, then -1.
    for s in np.nonzero(~do_sample)[0]:
        r = s % (k + 1)
        assert list(got[s, :r]) == list(draft_ids[s, :r])
        assert got[s, r] == target[s, r].argmax()
        assert (got[s, r + 1 :] == -1).all()


def test_draft_equal_to_target_keeps_every_draft_and_the_bonus():
    S, k, V = 64, 3, 16
    rng = np.random.default_rng(1)
    p = _probs(rng, S, k + 1, V)
    draft_ids = rng.integers(0, V, (S, k)).astype(np.int32)
    out = _port_sample(False, draft_ids, p[:, :k].copy(), p, np.ones(S, bool), np.arange(S, dtype=np.uint32))
    np.testing.assert_array_equal(out[:, :k], draft_ids)
    assert ((out[:, k] >= 0) & (out[:, k] < V)).all()


def test_target_zero_at_the_draft_token_rejects_at_0_and_draws_from_the_residual():
    S, k, V = 64, 3, 16
    rng = np.random.default_rng(2)
    target = _probs(rng, S, k + 1, V)
    draft_probs = _probs(rng, S, k, V)
    draft_ids = rng.integers(0, V, (S, k)).astype(np.int32)
    target[np.arange(S), 0, draft_ids[:, 0]] = 0.0
    target /= target.sum(-1, keepdims=True)
    out = _port_sample(False, draft_ids, draft_probs, target, np.ones(S, bool), np.arange(S, dtype=np.uint32) * 7)
    assert (out[:, 1:] == -1).all()
    residual = np.maximum(target[np.arange(S), 0] - draft_probs[:, 0], 0.0)
    assert (residual[np.arange(S), out[:, 0]] > 0).all()
    # The one-hot form: the proposed token is zeroed in the recovery.
    out = _port_sample(True, draft_ids, None, target, np.ones(S, bool), np.arange(S, dtype=np.uint32))
    assert (out[:, 1:] == -1).all() and (out[:, 0] != draft_ids[:, 0]).all()


@pytest.mark.parametrize("onehot", [False, True])
def test_first_emitted_token_follows_the_target_distribution(onehot):
    """Chi-square over 40000 rows of one target p and draft q (drafts drawn
    from q; one fixed proposal for the one-hot form): speculative sampling
    emits p whatever q is."""
    from scipy.stats import chisquare

    S, k, V = 40000, 2, 6
    rng = np.random.default_rng(3)
    p = np.array([0.3, 0.25, 0.2, 0.15, 0.07, 0.03], np.float32)
    q = np.array([0.05, 0.1, 0.15, 0.2, 0.25, 0.25], np.float32)
    target = np.broadcast_to(p, (S, k + 1, V)).copy()
    draft_probs = np.broadcast_to(q, (S, k, V)).copy()
    if onehot:
        draft_ids = np.full((S, k), 4, np.int32)
    else:
        draft_ids = rng.choice(V, size=(S, k), p=q).astype(np.int32)
    seeds = rng.integers(0, 2**32, S, dtype=np.uint64).astype(np.uint32)
    out = _port_sample(onehot, draft_ids, draft_probs, target, np.ones(S, bool), seeds)
    counts = np.bincount(out[:, 0], minlength=V)
    expected = p.astype(np.float64) / p.astype(np.float64).sum()
    assert chisquare(counts, S * expected).pvalue > 1e-3
    # The same seeds draw the same tokens.
    np.testing.assert_array_equal(out, _port_sample(onehot, draft_ids, draft_probs, target, np.ones(S, bool), seeds))


def test_propose_ngram_matches_jax_on_seeded_lists():
    from scalellm_tpu.speculative.ngram import propose_ngram as jax_propose
    from scalellm_tpu_torch.speculative.ngram import propose_ngram

    rng = np.random.default_rng(4)
    for _ in range(300):
        toks = rng.integers(0, 5, int(rng.integers(0, 40))).tolist()
        k = int(rng.integers(1, 6))
        assert propose_ngram(toks, k) == jax_propose(toks, k)
        assert propose_ngram(toks, k, 1, 3) == jax_propose(toks, k, 1, 3)


@settings(max_examples=150, deadline=None)
@given(toks=st.lists(st.integers(0, 3), max_size=30), k=st.integers(1, 6), min_n=st.integers(1, 3),
       extra=st.integers(0, 3))
def test_propose_ngram_matches_jax_on_drawn_lists(toks, k, min_n, extra):
    from scalellm_tpu.speculative.ngram import propose_ngram as jax_propose
    from scalellm_tpu_torch.speculative.ngram import propose_ngram

    assert propose_ngram(toks, k, min_n, min_n + extra) == jax_propose(toks, k, min_n, min_n + extra)


# ------------------------------------------------------------ end to end


def _ids(llm_cls, sp_cls, path, prompts=PROMPTS, max_tokens=10, chunk=16, **kw):
    """Greedy ids of `prompts`; chunk: the batch's token budget (16 is below
    the longest prompt: chunked prefill)."""
    llm = llm_cls(path, block_size=4, num_blocks=256, max_tokens_per_batch=chunk, **kw)
    try:
        outs = generate_within(llm, prompts, sp_cls(max_tokens=max_tokens, temperature=0.0, ignore_eos=True))
        for o in outs:
            assert o.status.ok and o.finished and o.usage.num_generated_tokens == max_tokens
        return [o.outputs[0].token_ids for o in outs]
    finally:
        llm.close()


def _counters():
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    return COUNTERS.get("num_accepted_tokens_total"), COUNTERS.get("num_draft_tokens_total")


def _jax_ids(path, **kw):
    """scalellm_tpu.LLM's greedy ids, without chunked prefill: the
    reference's draft engine builds the draft's KV for every uncached token
    of a sequence, past the blocks a chunk holds, and fails there."""
    from scalellm_tpu import LLM, SamplingParams

    return _ids(LLM, SamplingParams, path, chunk=512, enable_cuda_graph=False, **kw)


def _port_ids(path, **kw):
    from scalellm_tpu_torch import LLM, SamplingParams

    return _ids(LLM, SamplingParams, path, devices="cpu", **kw)


@pytest.fixture(scope="module")
def plain_ids(tiny_model):
    from scalellm_tpu_torch import LLM, SamplingParams

    return _ids(LLM, SamplingParams, tiny_model, devices="cpu")


def _draft_latency_samples(histograms) -> int:
    h = histograms.get("draft_execution_latency_seconds")
    return h.count if h is not None else 0


@pytest.fixture(scope="module")
def self_draft_unchunked(tiny_model):
    """The fixture as its own draft, k = 3, without chunked prefill, through
    both packages: each one's greedy ids and the samples its
    draft_execution_latency_seconds histogram gained."""
    from scalellm_tpu.utils.metrics import HISTOGRAMS as JAX_HISTOGRAMS
    from scalellm_tpu_torch.utils.metrics import HISTOGRAMS

    spec = dict(draft_model=tiny_model, num_speculative_tokens=3)
    out = {}
    for name, run, hist in (("port", lambda: _port_ids(tiny_model, chunk=512, **spec), HISTOGRAMS),
                            ("jax", lambda: _jax_ids(tiny_model, **spec), JAX_HISTOGRAMS)):
        n0 = _draft_latency_samples(hist)
        out[name] = run(), _draft_latency_samples(hist) - n0
    return out


@pytest.mark.parametrize("graphs", [True, False])
def test_draft_model_greedy_matches_plain_and_jax(tiny_model, plain_ids, self_draft_unchunked, graphs, monkeypatch):
    """The fixture as its own draft, k = 3, chunked prefill (16-token
    budget), four concurrent requests: every round keeps all k drafts and
    the bonus token."""
    from scalellm_tpu_torch import LLM, SamplingParams
    from scalellm_tpu_torch.speculative.spec_executor import SpecExecutor

    rows, real = [], SpecExecutor.execute

    def spy(self, arrays, S, MAXP):
        accepted, draft_ids = real(self, arrays, S, MAXP)
        rows.append(accepted[: int(arrays["num_seqs"][0])])
        return accepted, draft_ids

    monkeypatch.setattr(SpecExecutor, "execute", spy)
    acc0, drafted0 = _counters()
    got = _ids(LLM, SamplingParams, tiny_model, devices="cpu", draft_model=tiny_model, num_speculative_tokens=3,
               enable_cuda_graph=graphs)
    acc, drafted = _counters()
    assert got == plain_ids
    assert rows and all((r >= 0).all() for r in rows)
    assert drafted - drafted0 == 3 * sum(len(r) for r in rows)
    assert acc > acc0
    if graphs:
        got, want = self_draft_unchunked["port"][0], self_draft_unchunked["jax"][0]
        assert got == _port_ids(tiny_model, chunk=512) == want


def test_draft_latency_histogram_counts_what_the_reference_counts(self_draft_unchunked):
    """The same greedy traffic through both packages, the fixture as its own
    draft (every draft kept, so a catch-up step follows every round): the
    draft_execution_latency_seconds histogram gains as many samples in the
    port as in the reference, which observes it only around the draft's KV
    build in a step with a prefill chunk, never around a catch-up."""
    (got, port_samples), (want, jax_samples) = self_draft_unchunked["port"], self_draft_unchunked["jax"]
    assert got == want
    assert port_samples == jax_samples > 0


def test_another_draft_model_greedy_matches_plain_and_jax():
    """A draft of other weights (the hidden-64 fixture for the hidden-128
    one): drafts are rejected, and greedy output stays the target's."""
    from scalellm_tpu_torch import LLM, SamplingParams

    target, draft = tiny_llama(128), tiny_llama(64)
    want = _ids(LLM, SamplingParams, target, devices="cpu")
    acc0, drafted0 = _counters()
    got = _ids(LLM, SamplingParams, target, devices="cpu", draft_model=draft, num_speculative_tokens=2)
    acc, drafted = _counters()
    assert got == want
    assert 0 < acc - acc0 < (drafted - drafted0) // 2 * 3  # some drafts rejected
    spec = dict(draft_model=draft, num_speculative_tokens=2)
    assert _port_ids(target, chunk=512, **spec) == _jax_ids(target, **spec)


def test_ngram_greedy_matches_plain_and_jax(tiny_model):
    """Prompt lookup on prompts that repeat (the random fixture also falls
    into loops that the proposer then copies)."""
    from scalellm_tpu_torch import LLM, SamplingParams

    prompts = ["the cat sat on the mat. the cat", "a b c a b", "hello hello", "abcabcabcabc"]
    want = _ids(LLM, SamplingParams, tiny_model, prompts, max_tokens=24, devices="cpu")
    acc0, _ = _counters()
    got = _ids(LLM, SamplingParams, tiny_model, prompts, max_tokens=24, devices="cpu", num_speculative_tokens=3)
    assert got == want
    assert _counters()[0] > acc0
    assert _port_ids(tiny_model, prompts=prompts, max_tokens=24, chunk=512, num_speculative_tokens=3) == \
        _jax_ids(tiny_model, prompts=prompts, max_tokens=24, num_speculative_tokens=3)


def test_irregular_kv_lag_falls_back_to_a_plain_step(tiny_model):
    """A decode entry whose target KV lags by 2 (as after a preemption mid
    round) takes a plain target step instead of a round."""
    from scalellm_tpu_torch.engine.batch import Batch
    from scalellm_tpu_torch.engine.llm_engine import EngineOptions
    from scalellm_tpu_torch.request.sequence import EngineType, Sequence
    from scalellm_tpu_torch.request.stopping import StoppingCriteria
    from scalellm_tpu_torch.sampling.params import SamplingParams
    from scalellm_tpu_torch.speculative.speculative_engine import SpeculativeEngine

    eng = SpeculativeEngine(EngineOptions(model_path=tiny_model, device="cpu", draft_model_path=tiny_model,
                                          num_speculative_tokens=2, block_size=4, num_blocks=64,
                                          warmup_mode="off"))
    seq = Sequence(0, [1, 2, 3], SamplingParams(max_tokens=8, ignore_eos=True),
                   StoppingCriteria(max_tokens=8, ignore_eos=True))
    eng.block_manager.allocate_blocks_for(seq, 8)
    b = Batch()
    b.add(seq, 3)
    eng.execute_model(b)  # the prefill: the draft builds its KV, the target samples
    assert seq.num_tokens == 4
    assert seq.num_kv_cache_tokens(EngineType.LLM) == 3 and seq.num_kv_cache_tokens(EngineType.SSM) == 3
    seq._num_kv_cache_tokens[EngineType.LLM] = 2
    seq.engine_type = EngineType.SSM  # the entry counts under the draft (lag 1)
    b2 = Batch()
    b2.add(seq, 1)
    eng.execute_model(b2)
    assert seq.num_tokens == 5  # one plain step: one token, no round


def test_draft_kv_build_follows_the_target_chunk(tiny_model):
    """A prefill chunk: the draft builds its KV for the target's chunk, no
    further, and samples nothing."""
    from scalellm_tpu_torch.engine.batch import Batch
    from scalellm_tpu_torch.engine.llm_engine import EngineOptions
    from scalellm_tpu_torch.request.sequence import EngineType, Sequence
    from scalellm_tpu_torch.request.stopping import StoppingCriteria
    from scalellm_tpu_torch.sampling.params import SamplingParams
    from scalellm_tpu_torch.speculative.speculative_engine import SpeculativeEngine

    eng = SpeculativeEngine(EngineOptions(model_path=tiny_model, device="cpu", draft_model_path=tiny_model,
                                          num_speculative_tokens=2, block_size=4, num_blocks=64,
                                          enable_cuda_graph=False))
    seq = Sequence(0, list(range(1, 11)), SamplingParams(max_tokens=8, ignore_eos=True),
                   StoppingCriteria(max_tokens=8, ignore_eos=True))
    eng.block_manager.allocate_blocks_for(seq, 12)
    b = Batch()
    b.add(seq, 6)
    eng.execute_model(b)
    assert seq.num_tokens == 10
    assert seq.num_kv_cache_tokens(EngineType.LLM) == 6 and seq.num_kv_cache_tokens(EngineType.SSM) == 6


def test_sampled_speculation_is_repeatable(tiny_model):
    from scalellm_tpu_torch import LLM, SamplingParams

    sps = [SamplingParams(max_tokens=12, temperature=1.0, top_p=0.9, seed=11 + i, ignore_eos=True)
           for i in range(len(PROMPTS))]
    runs = []
    for _ in range(2):
        llm = LLM(tiny_model, devices="cpu", block_size=4, num_blocks=256, draft_model=tiny_llama(128),
                  num_speculative_tokens=3)
        outs = generate_within(llm, PROMPTS, sps)
        llm.close()
        assert all(o.finished and o.usage.num_generated_tokens == 12 for o in outs)
        runs.append([o.outputs[0].token_ids for o in outs])
    assert runs[0] == runs[1]


def test_lora_with_speculation_is_a_value_error(tiny_model):
    from scalellm_tpu_torch.handlers.llm_handler import LLMHandlerOptions

    for spec in (dict(draft_model_path=tiny_model, num_speculative_tokens=2), dict(num_speculative_tokens=2)):
        with pytest.raises(ValueError, match="LoRA"):
            LLMHandlerOptions(lora_modules={"a": "b"}, **spec).check_ported()
        LLMHandlerOptions(**spec).check_ported()


def test_a_draft_of_another_vocab_is_a_value_error(tiny_model, tmp_path):
    """The check reads the draft's config alone (a config of vocab 320
    beside the fixture's tokenizer: no weights are loaded)."""
    import json
    import shutil

    from scalellm_tpu_torch import LLM

    other = tmp_path / "draft"
    other.mkdir()
    with open(os.path.join(tiny_model, "config.json")) as f:
        cfg = json.load(f)
    cfg["vocab_size"] = 320
    (other / "config.json").write_text(json.dumps(cfg))
    shutil.copy(os.path.join(tiny_model, "tokenizer.json"), other / "tokenizer.json")
    with pytest.raises(ValueError, match="vocab"):
        LLM(tiny_model, devices="cpu", num_blocks=64, draft_model=other, num_speculative_tokens=2)


def test_round_buffer_round_trips_and_plan():
    import torch

    from scalellm_tpu_torch.speculative.spec_executor import pack_round, round_plan, round_views

    S, P, k = 4, 16, 3
    rng = np.random.default_rng(5)
    a = dict(first_tokens=rng.integers(0, 9, S).astype(np.int32), slot_ids=rng.integers(0, 99, (S, k + 1)),
             block_tables=rng.integers(0, 99, (S, P)).astype(np.int32), seq_mask=np.ones(S, np.float32),
             temperatures=np.array([0.0, 0.7, 0.0, 1.0], np.float32), top_ks=np.zeros(S, np.int32),
             top_ps=np.ones(S, np.float32), seeds=np.array([1, 2**32 - 1, 5, 2**31], np.uint32),
             draft_ids=rng.integers(0, 9, (S, k)).astype(np.int32))
    v = round_views(torch.from_numpy(pack_round(a, S, P, k)), S, P, k)
    for name, want in a.items():
        got = v[name].numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(v["positions0"].numpy(), 0)
    plan = round_plan(a)
    assert plan.temperature and not (plan.top_k_top_p or plan.bias or plan.penalties or plan.allowed_mask)
