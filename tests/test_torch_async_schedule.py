"""Async scheduling in the port (scheduler/continuous_scheduler.py: one step
in flight, its pending tokens merged on the device), on the CPU with the
tiny Llama checkpoint, after tests/test_async_schedule.py. The plain paths
are deterministic here, so an async serve gives exactly the tokens of the
sync serve:

- greedy, with async steps taken (num_async_steps grows) and none in the
  sync serve;
- seeded sampling (the same seeds at the same steps: the sampler's noise is
  a function of a row's seed alone);
- penalties fall back to synchronous steps;
- logprobs, and their top alternatives;
- a stop token met mid-pipeline stays hidden;
- KV pressure (a pipelined build cannot preempt: the next step runs
  synchronously);
- n > 1 (the expansion waits for the pipeline to drain);
- the tiny DeepSeek-V2;
- the port's async serve gives the JAX package's async serve's greedy ids.
"""

import pytest

from tests.torch_port_util import generate_within, tiny_llama

PROMPTS = ["hello world", "abcdef", "xyz xyz xyz", "q"]


@pytest.fixture(scope="module")
def model_dir():
    return tiny_llama()


def _generate(model_dir, prompts, sps, async_on, **kw):
    from scalellm_tpu_torch import LLM

    kw.setdefault("num_blocks", 256)
    llm = LLM(model_dir, devices="cpu", block_size=4, num_handling_threads=1,
              enable_async_scheduling=async_on, **kw)
    try:
        if len(sps) == 1:
            sps = sps * len(prompts)
        outs = generate_within(llm, prompts, sps)
        return [[(so.token_ids, so.text, so.finish_reason) for so in o.outputs] for o in outs]
    finally:
        llm.close()


def _counters():
    from scalellm_tpu_torch.utils.metrics import COUNTERS, STEP_COUNTERS

    return {name: COUNTERS.get(name) for name in STEP_COUNTERS}


@pytest.mark.parametrize("graphs", [True, False])
def test_async_matches_sync_greedy(model_dir, graphs):
    """graphs: the pending merge on the step buffer between its fill and
    the (CPU) replay, or on the eager step's inputs."""
    from scalellm_tpu_torch import SamplingParams

    sps = [SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)]
    base = _counters()
    sync = _generate(model_dir, PROMPTS, sps, async_on=False, enable_cuda_graph=graphs)
    mid = _counters()
    assert mid["num_async_steps"] == base["num_async_steps"], "the sync serve took async steps"
    asy = _generate(model_dir, PROMPTS, sps, async_on=True, enable_cuda_graph=graphs)
    end = _counters()
    assert end["num_async_steps"] > mid["num_async_steps"], "no async step was taken"
    assert end["num_engine_steps"] - mid["num_engine_steps"] >= end["num_async_steps"] - mid["num_async_steps"]
    assert asy == sync
    assert all(len(o[0][0]) for o in asy)


def test_async_matches_sync_sampled(model_dir):
    from scalellm_tpu_torch import SamplingParams

    prompts = ["the quick", "brown fox"]
    sps = [SamplingParams(max_tokens=10, temperature=0.0),
           SamplingParams(max_tokens=10, temperature=0.8, seed=1234)]
    sync = _generate(model_dir, prompts, sps, async_on=False)
    asy = _generate(model_dir, prompts, sps, async_on=True)
    assert asy == sync


def test_async_falls_back_for_penalties(model_dir):
    from scalellm_tpu_torch import SamplingParams

    sps = [SamplingParams(max_tokens=8, temperature=0.0, repetition_penalty=1.3, ignore_eos=True)]
    sync = _generate(model_dir, ["penalty test"], sps, async_on=False)
    before = _counters()
    asy = _generate(model_dir, ["penalty test"], sps, async_on=True)
    assert _counters()["num_async_steps"] == before["num_async_steps"]
    assert asy == sync


def test_async_with_logprobs(model_dir):
    from scalellm_tpu_torch import LLM, SamplingParams

    sp = SamplingParams(max_tokens=6, temperature=0.0, logprobs=True, top_logprobs=3, ignore_eos=True)
    got = {}
    for async_on in (False, True):
        with LLM(model_dir, devices="cpu", num_blocks=256, block_size=4,
                 enable_async_scheduling=async_on) as llm:
            so = generate_within(llm, ["logprob run"], [sp])[0].outputs[0]
        assert so.logprobs and len(so.logprobs) == 6
        assert all(lp.top_logprobs and len(lp.top_logprobs) == 3 for lp in so.logprobs)
        got[async_on] = [(lp.token_id, lp.logprob, [(t.token_id, t.logprob) for t in lp.top_logprobs])
                         for lp in so.logprobs]
    assert got[True] == got[False]


def test_async_stop_token_hidden(model_dir):
    """A stop token sampled mid-pipeline: the next step, already dispatched,
    sampled past it; that overshoot is dropped."""
    from scalellm_tpu_torch import LLM, SamplingParams
    from scalellm_tpu_torch.request.output import FinishReason

    with LLM(model_dir, devices="cpu", num_blocks=256, block_size=4) as llm:
        probe = generate_within(llm, ["stop probe"], [SamplingParams(max_tokens=6, temperature=0.0,
                                                             ignore_eos=True)])[0].outputs[0]
        stop_tok = probe.token_ids[2]
        so = generate_within(llm, ["stop probe"], [SamplingParams(max_tokens=6, temperature=0.0,
                                                          stop_token_ids=[stop_tok])])[0].outputs[0]
    assert so.finish_reason == FinishReason.STOP
    assert so.token_ids == probe.token_ids[:2]
    assert so.text == probe.text[:len(so.text)] and len(so.text) < len(probe.text)


def test_async_preemption_pressure(model_dir):
    """A tiny KV pool: a pipelined build that cannot allocate runs the next
    step synchronously, where preemption makes room; everything finishes
    with the sync serve's tokens."""
    from scalellm_tpu_torch import SamplingParams

    from scalellm_tpu_torch.utils.metrics import COUNTERS

    prompts = [f"req {i} pad pad pad" for i in range(6)]
    sps = [SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True)]
    sync = _generate(model_dir, prompts, sps, async_on=False, num_blocks=40)
    before = COUNTERS.get("num_preempted_requests"), _counters()["num_async_steps"]
    asy = _generate(model_dir, prompts, sps, async_on=True, num_blocks=40)
    assert COUNTERS.get("num_preempted_requests") > before[0]  # the pool was short
    assert _counters()["num_async_steps"] > before[1]
    assert asy == sync
    assert all(len(o[0][0]) == 16 for o in asy)


def test_async_n_expansion(model_dir):
    """n > 1 defers the expansion while a step is in flight and completes."""
    from scalellm_tpu_torch import LLM, SamplingParams

    with LLM(model_dir, devices="cpu", num_blocks=256, block_size=4) as llm:
        out = generate_within(llm, ["expand me"], [SamplingParams(max_tokens=5, n=3, temperature=0.7, seed=7,
                                                          ignore_eos=True)])[0]
    assert len(out.outputs) == 3
    assert all(so.finish_reason is not None and so.text for so in out.outputs)
    assert out.usage.num_generated_tokens == 15


def test_async_matches_sync_deepseek():
    """The tiny DeepSeek-V2 (MLA's decode path, MoE): async = sync."""
    from tests.test_torch_cuda_graph import shared_tiny_deepseek
    from scalellm_tpu_torch import SamplingParams

    path = shared_tiny_deepseek()
    sps = [SamplingParams(max_tokens=7, temperature=0.0, ignore_eos=True)]
    sync = _generate(path, PROMPTS, sps, async_on=False)
    before = _counters()["num_async_steps"]
    asy = _generate(path, PROMPTS, sps, async_on=True)
    assert _counters()["num_async_steps"] > before
    assert asy == sync


@pytest.fixture(scope="module")
def jax_async(model_dir):
    """The JAX package's async serve of PROMPTS, greedy (run once)."""
    from scalellm_tpu import LLM, SamplingParams

    with LLM(model_dir, block_size=4, num_blocks=128, max_tokens_per_batch=16, enable_cuda_graph=False,
             enable_async_scheduling=True) as llm:
        return [o.outputs[0].token_ids
                for o in generate_within(llm, PROMPTS, SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))]


def test_async_greedy_matches_jax(model_dir, jax_async):
    from scalellm_tpu_torch import LLM, SamplingParams

    before = _counters()
    with LLM(model_dir, devices="cpu", block_size=4, num_blocks=128, max_tokens_per_batch=16,
             num_handling_threads=1) as llm:
        got = [o.outputs[0].token_ids
               for o in generate_within(llm, PROMPTS, SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))]
    assert _counters()["num_async_steps"] > before["num_async_steps"]
    assert got == jax_async
