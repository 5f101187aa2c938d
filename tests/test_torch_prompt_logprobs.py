"""Prompt logprobs (SamplingParams.prompt_logprobs) in the port against the
JAX package, on the CPU: the engine's score step (Executor.execute_score:
every row's hidden state, the lm_head over chunks of 128 rows, an f32
log_softmax, the target's logprob and the top-k) and the batch's score
targets and write-back (Batch.process_prompt_scores).

- LLM.generate's prompt_logprobs equal scalellm_tpu.LLM's within 1e-4 (the
  float32 fixture; the two packages' products differ in rounding alone),
  with the same top-k ids, whole and with chunked prefill, with CUDA graphs
  on and off, over a prompt long enough for two 128-row chunks, and on a
  second pass through the prefix cache;
- the batch's score targets and top-k equal the JAX batch's;
- under speculative decoding the same values as without.
"""

import numpy as np
import pytest

from tests.torch_port_util import generate_within, tiny_llama

PROMPTS = ["hello world", "the quick brown fox jumps over the lazy dog " * 3, "abc"]
TOL = 1e-4


@pytest.fixture(scope="module")
def tiny_model():
    return tiny_llama()


def _scores(llm_cls, sp_cls, path, top=3, passes=1, **kw):
    """Per pass and prompt: [(token id, logprob, top ids) or None]."""
    llm = llm_cls(path, block_size=4, num_blocks=512, **kw)
    try:
        sp = sp_cls(max_tokens=3, temperature=0.0, ignore_eos=True, prompt_logprobs=top)
        out = []
        for _ in range(passes):
            got = []
            for o in generate_within(llm, PROMPTS, sp):
                assert o.status.ok and o.finished
                got.append([None if lp is None else (lp.token_id, lp.logprob, [d.token_id for d in lp.top_logprobs])
                            for lp in o.prompt_logprobs])
            out.append(got)
        return out
    finally:
        llm.close()


def _assert_close(got, want):
    for g_pass, w_pass in zip(got, want, strict=True):
        for g, w in zip(g_pass, w_pass, strict=True):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert (a is None) == (b is None)
                if a is None:
                    continue
                assert a[0] == b[0] and a[2] == b[2]
                assert abs(a[1] - b[1]) <= TOL


@pytest.fixture(scope="module")
def jax_scores(tiny_model):
    from scalellm_tpu import LLM, SamplingParams

    return _scores(LLM, SamplingParams, tiny_model, passes=2, enable_cuda_graph=False)


@pytest.mark.parametrize("chunk, graphs", [(409600, True), (32, True), (32, False)])
def test_prompt_logprobs_match_jax(tiny_model, jax_scores, chunk, graphs):
    """chunk: the batch's token budget (32: the long prompt's prefill in
    chunks, scored chunk by chunk). The second pass goes through the
    prefix cache."""
    from scalellm_tpu_torch import LLM, SamplingParams

    got = _scores(LLM, SamplingParams, tiny_model, passes=2, devices="cpu", max_tokens_per_batch=chunk,
                  enable_cuda_graph=graphs)
    assert got[0][1][1] is not None and len(got[0][1]) > 128
    assert got[0][0][0] is None
    _assert_close(got, jax_scores)


def test_score_targets_match_the_jax_batch():
    """A mixed batch: a prefill chunk that scores, one that does not ask,
    a last chunk whose final position has no target, and a decode step."""
    from scalellm_tpu.engine.batch import Batch as JaxBatch
    from scalellm_tpu.memory.block import Block as JaxBlock
    from scalellm_tpu.request.sequence import Sequence as JaxSequence
    from scalellm_tpu.request.stopping import StoppingCriteria as JaxStopping
    from scalellm_tpu.sampling.params import SamplingParams as JaxSP
    from scalellm_tpu_torch.engine.batch import Batch
    from scalellm_tpu_torch.memory.block import Block
    from scalellm_tpu_torch.request.sequence import Sequence
    from scalellm_tpu_torch.request.stopping import StoppingCriteria
    from scalellm_tpu_torch.sampling.params import SamplingParams

    def build(batch_cls, seq_cls, sp_cls, stop_cls, block_cls):
        b = batch_cls()
        # (prompt, prompt_logprobs, cached tokens, chunk)
        specs = [(list(range(1, 12)), 2, 0, 6), (list(range(20, 30)), None, 0, 5),
                 (list(range(40, 49)), 4, 5, 4), (list(range(60, 66)), 1, 6, 1)]
        for i, (prompt, top, cached, n) in enumerate(specs):
            seq = seq_cls(0, prompt, sp_cls(max_tokens=4, prompt_logprobs=top), stop_cls(max_tokens=4))
            if cached == len(prompt):
                seq.append_token(70)  # a decode step
            seq.append_blocks([block_cls(10 * i + j + 1, 4) for j in range(4)])
            seq.commit_kv_cache(cached)
            b.add(seq, n)
        return b

    jb = build(JaxBatch, JaxSequence, JaxSP, JaxStopping, JaxBlock)
    pb = build(Batch, Sequence, SamplingParams, StoppingCriteria, Block)
    jb.prepare_model_inputs(4)
    pb.prepare_model_inputs(4)
    np.testing.assert_array_equal(pb.score_targets, jb.score_targets)
    assert pb.score_top_k == jb.score_top_k == 4
    T = len(pb.score_targets)
    rng = np.random.default_rng(0)
    t_lps, top_ids, top_lps = rng.standard_normal(T), rng.integers(0, 50, (T, 4)), rng.standard_normal((T, 4))
    pb.process_prompt_scores(t_lps, top_ids, top_lps)
    jb.process_prompt_scores(t_lps, top_ids, top_lps)
    for pe, je in zip(pb.entries, jb.entries):
        pl, jl = pe.seq.prompt_logprobs, je.seq.prompt_logprobs
        assert (pl is None) == (jl is None)
        for a, b in zip(pl or [], jl or []):
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.token_id, a.logprob) == (b.token_id, b.logprob)
                assert [(d.token_id, d.logprob) for d in a.top_logprobs] == \
                    [(d.token_id, d.logprob) for d in b.top_logprobs]


def test_prompt_logprobs_under_speculation_equal_plain(tiny_model):
    """The draft's KV build and the target's scored step of a speculative
    engine give the plain engine's values; so does prompt lookup."""
    from scalellm_tpu_torch import LLM, SamplingParams

    want = _scores(LLM, SamplingParams, tiny_model, devices="cpu", max_tokens_per_batch=32)
    for spec in (dict(draft_model=tiny_llama(128), num_speculative_tokens=2), dict(num_speculative_tokens=3)):
        got = _scores(LLM, SamplingParams, tiny_model, devices="cpu", max_tokens_per_batch=32, **spec)
        _assert_close(got, want)
