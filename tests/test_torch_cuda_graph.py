"""The port's step graphs (engine/executor.py: StepGraphs, warmup) on the
CPU, where a bucket's "replay" runs the step function on the same static
step buffer, keys and counters as the CUDA form:

- LLM.generate gives the same tokens, text and logprobs with
  enable_cuda_graph on and off (tiny Llama with chunked prefill and a
  second pass through the prefix cache; tiny DeepSeek-V2 in bf16's place
  f32, and with runtime INT4);
- a bucket that ran 8 sequences and then runs 5 gives the eager logits and
  KV cache: every step rewrites the whole bucket, padding included;
- bucket keys: decode-only and mixed steps share a dense model's graph and
  not an MLA model's;
- the warmup buckets are the reference's (scalellm_tpu's
  Executor.warmup, recorded through an execute that only notes the
  bucket) for "fast" and "full";
- num_mid_serve_compiles counts the captures outside warmup only;
- the handler's options: CUDA graphs, warmup, async scheduling and
  multi-step decode accepted with the reference's defaults, speculative
  decoding accepted, the rest still refused, an unknown warmup mode a
  ValueError;
- the sampler reads no SamplingInputs on a greedy step (its branches come
  from the host arrays).

The card's form (real captures and replays, bit-equal to eager) is held by
tests/test_torch_kernels.py."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tests.fixtures as fixtures
from tests.test_torch_model import _inputs
from tests.torch_port_util import generate_within, shared_checkpoint, tiny_llama

PROMPTS = [
    "the quick brown fox jumps over",
    "the quick brown fox sleeps",
    "abc",
    "hello world, hello world",
]


def _tiny_deepseek(d, seed):
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    from tests.test_torch_deepseek import HF_KW, YARN

    torch.manual_seed(seed)
    DeepseekV2ForCausalLM(DeepseekV2Config(**HF_KW)).to(torch.float32).save_pretrained(
        d, safe_serialization=True)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    cfg["rope_scaling"] = YARN
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    fixtures.save_char_tokenizer(d)
    return d


def shared_tiny_deepseek():
    """_tiny_deepseek at seed 0, built once for every test process."""
    return shared_checkpoint("tiny_deepseek_v2_yarn_f32_seed0_tok", lambda d: _tiny_deepseek(d, seed=0))


@pytest.fixture(scope="module")
def deepseek():
    return shared_tiny_deepseek()


@pytest.fixture(scope="module")
def llama():
    return tiny_llama()


def _generate(path, graphs, **kw):
    from scalellm_tpu_torch import LLM, SamplingParams

    # One request-handling thread enqueues the prompts in order (several
    # race), so both runs build the same batches and can agree bit for bit.
    llm = LLM(path, devices="cpu", block_size=4, num_blocks=128, max_tokens_per_batch=16,
              num_handling_threads=1, enable_cuda_graph=graphs, **kw)
    try:
        sp = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True, logprobs=True,
                            top_logprobs=2)
        # The second pass re-reads the shared prompt blocks from the prefix cache.
        outs = [generate_within(llm, PROMPTS, sp) for _ in range(2)]
        graphs_made = len(llm._handler.engine.executor.graphs.graphs) if graphs else 0
        return [[(o.outputs[0].token_ids, o.outputs[0].text, o.outputs[0].logprobs,
                  o.usage.num_generated_tokens) for o in p] for p in outs], graphs_made
    finally:
        llm.close()


@pytest.mark.parametrize("model", ["llama", "deepseek", "deepseek_int4"])
def test_graphs_give_the_eager_tokens_text_and_logprobs(model, request):
    path = request.getfixturevalue("llama" if model == "llama" else "deepseek")
    kw = dict(quantize="int4") if model == "deepseek_int4" else {}
    got, n_graphs = _generate(path, True, **kw)
    want, _ = _generate(path, False, **kw)
    assert got == want
    assert all(n == 6 for p in got for *_, n in p)
    assert all(lp is not None and len(lp) == 6 for p in got for _, _, lp, _ in p)
    assert n_graphs >= 2  # the "fast" warmup's buckets, then mixed steps


def _engine(path, graphs=True, **kw):
    from scalellm_tpu_torch.engine.llm_engine import EngineOptions, LLMEngine

    return LLMEngine(EngineOptions(model_path=path, device="cpu", block_size=4, num_blocks=64,
                                   enable_cuda_graph=graphs, warmup_mode="off", **kw))


def _mi(chunks, S=8, T=16, maxp=4):
    from scalellm_tpu_torch.engine.params import ModelInputs

    return ModelInputs(**_inputs(chunks, S=S, T=T, maxp=maxp))


def test_a_smaller_batch_in_a_bucket_rewrites_its_padding(llama):
    """8 sequences of 2 tokens fill the T = 16, S = 8 bucket; then 5 of one
    token each leave 11 padding tokens and 3 padding slots that held real
    values. Stale padding would attend, and write KV into, real pages."""
    rng = np.random.default_rng(0)
    first = [(i, 0, rng.integers(1, 256, 2).tolist()) for i in range(8)]
    second = [(i, 2, [int(rng.integers(1, 256))]) for i in range(5)]
    graphs, eager = _engine(llama).executor, _engine(llama, graphs=False).executor
    with torch.inference_mode():
        for chunks in (first, second):
            mi = _mi(chunks)
            got = graphs.graphs.run(mi, decode_only=False).clone()
            want = eager._forward(mi.to("cpu"), False)
    assert len(graphs.graphs.graphs) == 1 and graphs.graphs.replays[(16, 8, 4, False)] == 2
    assert torch.equal(got, want)
    assert torch.equal(graphs.kv_cache, eager.kv_cache)
    # The buffer's bucket views hold the second batch, padding included.
    views = graphs.graphs.graphs[(16, 8, 4, False)].inputs
    for name, a in dataclasses.asdict(_mi(second)).items():
        if a is not None:
            assert np.array_equal(getattr(views, name).numpy(), a), name


@pytest.mark.parametrize("model,n_graphs", [("llama", 1), ("deepseek", 2)])
def test_decode_only_keeps_its_own_graph_only_for_mla(model, n_graphs, request):
    path = request.getfixturevalue(model)
    g = _engine(path).executor.graphs
    mi = _mi([(i, 0, [7]) for i in range(3)], S=4)
    with torch.inference_mode():
        a = g.run(mi, decode_only=False).clone()
        b = g.run(mi, decode_only=True).clone()
    assert len(g.graphs) == n_graphs
    assert g.key(16, 4, 4, True) == (16, 4, 4, model == "deepseek")
    assert g.mla == (model == "deepseek")
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _reference_buckets(block_size, mode, max_tokens, max_seqs, max_context_len):
    """The (T, S, MAXP, decode_only) of each step scalellm_tpu's warmup runs,
    in its order."""
    from scalellm_tpu.engine.executor import Executor as JaxExecutor

    ex = JaxExecutor.__new__(JaxExecutor)
    ex.model, ex._multiprocess, ex._in_warmup = None, False, False
    seen = []
    ex.execute = lambda mi, si, decode_only=False: seen.append(
        (mi.token_ids.shape[0], mi.kv_lens.shape[0], mi.block_tables.shape[1], decode_only))
    ex.warmup(block_size, mode=mode, max_tokens=max_tokens, max_seqs=max_seqs,
              max_context_len=max_context_len)
    return seen


ENVELOPES = {  # block_size, max_tokens_per_batch, max_seqs_per_batch, max_context_len
    "tests": (4, 16, 4, 64),
    "chip_smoke": (16, 512, 8, 1024),
    "handler_defaults": (16, 512, 128, 4096),
    "odd": (8, 300, 5, 1000),
}


@pytest.mark.parametrize("mode", ["fast", "full"])
@pytest.mark.parametrize("envelope", list(ENVELOPES))
def test_warmup_buckets_are_the_references(mode, envelope):
    from scalellm_tpu_torch.engine.executor import warmup_buckets

    want = _reference_buckets(*ENVELOPES[envelope][:1], mode, *ENVELOPES[envelope][1:])
    assert warmup_buckets(*ENVELOPES[envelope][:1], mode, *ENVELOPES[envelope][1:]) == want
    assert len(set(want)) == len(want) and want


def _serve(path, **opts):
    """Serve PROMPTS through an LLMHandler; returns (mid-serve captures
    during the serve, the executor's graphs)."""
    from scalellm_tpu_torch.handlers.llm_handler import LLMHandler, LLMHandlerOptions
    from scalellm_tpu_torch.sampling.params import SamplingParams
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    handler = LLMHandler(LLMHandlerOptions(model_path=path, devices="cpu", block_size=4, num_blocks=128,
                                           max_tokens_per_batch=16, **opts))
    try:
        before = COUNTERS.get("num_mid_serve_compiles")
        done = []
        for p in PROMPTS:
            handler.schedule_async(p, SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True),
                                   callback=lambda out: done.append(out.finished) or True)
        handler.run_until_complete()
        assert done.count(True) == len(PROMPTS)
        return COUNTERS.get("num_mid_serve_compiles") - before, handler.engine.executor.graphs
    finally:
        handler.stop()


def test_mid_serve_captures_count_outside_warmup_only(llama):
    from scalellm_tpu_torch.engine.executor import warmup_buckets

    added, graphs = _serve(llama, warmup_mode="off")
    assert added == len(graphs.graphs) > 0
    # Inside a "full" warmup's envelope (T is always 16 at a 16-token
    # budget, at most 4 sequences of at most 37 tokens, 16 pages) a serve
    # captures nothing more.
    added, graphs = _serve(llama, warmup_mode="full", max_seqs_per_batch=4, max_context_len=64)
    assert added == 0
    assert set(graphs.graphs) == {graphs.key(*b) for b in warmup_buckets(4, "full", 16, 4, 64)}
    assert sum(graphs.replays.values()) > len(graphs.graphs)


def test_handler_takes_graphs_and_warmup_and_refuses_the_rest():
    from scalellm_tpu_torch import LLM
    from scalellm_tpu_torch.handlers.llm_handler import LLMHandlerOptions

    import inspect

    defaults = LLMHandlerOptions()
    assert defaults.enable_cuda_graph is True and defaults.warmup_mode == "fast"
    assert inspect.signature(LLM).parameters["enable_cuda_graph"].default is True
    # Async scheduling and multi-step decode: the reference's defaults, accepted.
    assert defaults.enable_async_scheduling is True and defaults.num_decode_steps == 1
    assert inspect.signature(LLM).parameters["enable_async_scheduling"].default is True
    assert inspect.signature(LLM).parameters["num_decode_steps"].default == 1
    for mode in ("off", "fast", "full"):
        LLMHandlerOptions(enable_cuda_graph=True, warmup_mode=mode).check_ported()
    LLMHandlerOptions(enable_cuda_graph=False).check_ported()
    for ported in (dict(enable_async_scheduling=True), dict(enable_async_scheduling=False),
                   dict(num_decode_steps=4), dict(num_decode_steps=4, enable_async_scheduling=False)):
        LLMHandlerOptions(**ported).check_ported()
    with pytest.raises(ValueError, match="warmup_mode"):
        LLMHandlerOptions(warmup_mode="all").check_ported()
    # The int8 KV cache and KV swap: ported; an unknown KV dtype is refused.
    for ported in (dict(kv_cache_dtype="int8"), dict(host_swap_bytes=1)):
        LLMHandlerOptions(**ported).check_ported()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        LLMHandlerOptions(kv_cache_dtype="fp8").check_ported()
    # Speculative decoding: ported (LoRA with it is the reference's ValueError).
    for ported in (dict(num_speculative_tokens=2), dict(draft_model_path="draft", num_speculative_tokens=2)):
        LLMHandlerOptions(**ported).check_ported()
    # LoRA: ported (refused with speculation, as above).
    LLMHandlerOptions(lora_modules={"a": "b"}).check_ported()
    for unported in (dict(distributed=True), dict(tp_size=2)):
        with pytest.raises(NotImplementedError):
            LLMHandlerOptions(**unported).check_ported()


def test_a_greedy_step_reads_no_sampling_input():
    from scalellm_tpu_torch.engine.params import SamplingInputs
    from scalellm_tpu_torch.sampling.sampler import SamplingPlan, sample_tokens

    S, V = 4, 32
    host = SamplingInputs(
        temperatures=np.zeros(S, np.float32), top_ks=np.zeros(S, np.int32), top_ps=np.ones(S, np.float32),
        frequency_penalties=np.zeros(S, np.float32), presence_penalties=np.zeros(S, np.float32),
        repetition_penalties=np.ones(S, np.float32), unique_token_ids=np.zeros((S, 1), np.int32),
        unique_token_counts=np.zeros((S, 1), np.int32), bias_token_ids=np.zeros((S, 1), np.int32),
        bias_values=np.zeros((S, 1), np.float32), allowed_mask=np.full((S, 1), 0xFFFFFFFF, np.uint32),
        seeds=np.arange(S, dtype=np.uint32))
    plan = SamplingPlan.of(host)
    assert not plan.reads_inputs and not plan.temperature
    logits = torch.randn(S, V, generator=torch.Generator().manual_seed(0))
    unread = SamplingInputs(**{f.name: None for f in dataclasses.fields(SamplingInputs)})
    out = sample_tokens(logits, unread, max_top_logprobs=2, plan=plan)
    assert torch.equal(out.next_tokens, logits.argmax(-1).int())
    want = sample_tokens(logits, host.to("cpu"), max_top_logprobs=2)
    assert torch.equal(out.logprobs, want.logprobs) and torch.equal(out.top_ids, want.top_ids)
    # A sampling row: the plan's temperature stage reads the rows and their
    # seeds on the device.
    host.temperatures[2], host.seeds[2] = 0.7, 99
    plan = SamplingPlan.of(host)
    assert plan.reads_inputs and plan.temperature
