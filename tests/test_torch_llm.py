"""scalellm_tpu_torch.LLM against scalellm_tpu.LLM end to end on the tiny
Llama fixture with the char tokenizer, with chunked prefill (a 16-token
batch budget, below the longest prompt) and the prefix cache on (two prompts
share a prefix, and the second pass hits the cached blocks). Greedy token
ids and texts must be equal."""

import pytest

from tests.torch_port_util import generate_within, tiny_llama

PROMPTS = [
    "the quick brown fox jumps over",
    "the quick brown fox sleeps",
    "abc",
    "hello world, hello world",
]


@pytest.fixture(scope="module")
def tiny_model():
    return tiny_llama()  # fixtures.make_tiny_llama(tokenizer=True), shared


def _run(llm_cls, sp_cls, path, **kw):
    llm = llm_cls(path, block_size=4, num_blocks=128, max_tokens_per_batch=16, **kw)
    try:
        sp = sp_cls(max_tokens=6, temperature=0.0, ignore_eos=True)
        # The second pass re-reads the shared prompt blocks from the prefix cache.
        return [generate_within(llm, PROMPTS, sp) for _ in range(2)]
    finally:
        llm.close()


def test_greedy_outputs_match_jax(tiny_model):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams

    want = _run(JaxLLM, JaxSamplingParams, tiny_model, enable_cuda_graph=False)
    got = _run(LLM, SamplingParams, tiny_model, devices="cpu")
    for got_pass, want_pass in zip(got, want):
        assert len(got_pass) == len(PROMPTS)
        for g, w in zip(got_pass, want_pass):
            assert g.status.ok and g.finished
            assert g.outputs[0].token_ids == w.outputs[0].token_ids
            assert g.outputs[0].text == w.outputs[0].text
            assert g.usage.num_generated_tokens == 6
    assert got[0][0].outputs[0].token_ids == got[1][0].outputs[0].token_ids


def test_unported_options_raise(tiny_model):
    from scalellm_tpu_torch import LLM

    # Async scheduling (the default), multi-step decode and speculative
    # decoding are ported.
    LLM(tiny_model, devices="cpu", enable_async_scheduling=True, num_decode_steps=4).close()
    with pytest.raises(NotImplementedError):
        LLM(tiny_model, devices="cpu", tp_size=2)


def test_close_frees_the_engine_then_empties_the_device_cache(tiny_model, monkeypatch):
    """LLM.close drops the engine and then hands the caching allocator's
    free blocks back to the device: left cached, the next engine's first
    allocations land in the closed one's KV block, which then cannot be
    returned, and that engine sizes its own KV cache from the little the
    device reports free (seen on the card with several engines in one
    process). On the CPU the CUDA calls are stubbed."""
    import weakref

    import torch

    from scalellm_tpu_torch import LLM

    llm = LLM(tiny_model, devices="cpu")
    engine = weakref.ref(llm._handler.engine)
    alive_at_empty = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: alive_at_empty.append(engine() is not None))
    llm.close()
    assert alive_at_empty == [False]
