"""LLM.generate on the port's Mixtral against scalellm_tpu.LLM on the CPU:
the trained tiny Mixtral of tests/test_torch_moe_models.py (60 steps of
tests/fixtures.make_trained_tiny_mixtral: hidden 128, FFN 256, 4 experts
top-2, the char tokenizer), three prompts (two share a prefix), 8 greedy
tokens each, chunked prefill (a 16-token budget) and the prefix cache on.

- bf16 weights as they are: the sync, async and 4-step serves each give
  the JAX package's greedy ids;
- runtime INT4 (int4 experts at G = 128, qkv/o int4), the port's float
  reference forced (variant="ref", what the JAX package computes on the
  CPU): the sync serve gives the JAX package's INT4 ids."""

import functools

import pytest

from tests.test_torch_moe_models import trained_mixtral
from tests.torch_port_util import generate_within

PROMPTS = ["the quick brown fox jumps over", "the quick brown fox sleeps", "once upon a time"]
MODES = {
    "sync": dict(enable_async_scheduling=False),
    "async": dict(enable_async_scheduling=True),
    "ms4": dict(num_decode_steps=4),
}


def _generate(llm_cls, sp_cls, path, ref=False, **kw):
    llm = llm_cls(path, block_size=4, num_blocks=128, max_tokens_per_batch=16, **kw)
    try:
        if ref:
            from scalellm_tpu_torch.layers.moe import quant_expert_ffn
            from scalellm_tpu_torch.ops.quant_matmul import quant_matmul

            model = llm._handler.engine.model
            model.quant_impl = functools.partial(quant_matmul, variant="ref")
            model.qexperts_impl = functools.partial(quant_expert_ffn, variant="ref")
        sp = sp_cls(max_tokens=8, temperature=0.0, ignore_eos=True)
        return [o.outputs[0].token_ids for o in generate_within(llm, PROMPTS, sp)]
    finally:
        llm.close()


def _jax_ids(quantize):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams

    ids = _generate(JaxLLM, JaxSamplingParams, trained_mixtral(), quantize=quantize, enable_cuda_graph=False)
    assert all(len(t) == 8 for t in ids)
    return ids


@pytest.fixture(scope="module")
def jax_bf16_ids():
    return _jax_ids("")


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_generate_matches_jax(mode, jax_bf16_ids):
    from scalellm_tpu_torch import LLM, SamplingParams

    got = _generate(LLM, SamplingParams, trained_mixtral(), devices="cpu", num_handling_threads=1, **MODES[mode])
    assert got == jax_bf16_ids


def test_int4_greedy_generate_matches_jax():
    from scalellm_tpu_torch import LLM, SamplingParams

    got = _generate(LLM, SamplingParams, trained_mixtral(), ref=True, quantize="int4", devices="cpu",
                    num_handling_threads=1, **MODES["sync"])
    assert got == _jax_ids("int4")
