"""Multi-step decode in the port (num_decode_steps = N: a decode-only batch
runs N micro-steps in one dispatch, engine/executor.py:_multi_steps; with
CUDA graphs on, one graph per (N, bucket, sampling plan), on the CPU the
same keys and step buffer run eagerly), after tests/test_multi_step.py. The
plain paths are deterministic on the CPU, so greedy N = 4 gives exactly the
N = 1 tokens:

- several prompts, 40 tokens;
- max_tokens no multiple of N (the last window's overshoot is dropped);
- windows that cross a KV page (the slots recomputed on the device);
- logprobs;
- penalties fall back to single steps (no multi-step dispatch);
- mixed lengths in one batch (shorter sequences finish mid-window);
- page 0 stays reserved (overshoot past a sequence's pages writes there);
- graphs on and off give the same tokens, and the N-step graphs are
  captured at warmup and replayed;
- the tiny DeepSeek-V2 (MLA's decode kernel path);
- the port's N = 4 serve gives the JAX package's N = 4 serve's greedy ids.
"""

import pytest

from tests.torch_port_util import generate_within, tiny_llama


@pytest.fixture(scope="module")
def model_dir():
    return tiny_llama()


def _llm(path, n, **kw):
    from scalellm_tpu_torch import LLM

    kw.setdefault("num_blocks", 128)
    kw.setdefault("block_size", 16)
    return LLM(path, devices="cpu", enable_prefix_cache=False, num_decode_steps=n, num_handling_threads=1, **kw)


def _generate(path, n, prompts, sps, **kw):
    from scalellm_tpu_torch import SamplingParams

    if isinstance(sps, int):
        sps = SamplingParams(max_tokens=sps, temperature=0.0)
    with _llm(path, n, **kw) as llm:
        return [(o.outputs[0].token_ids, o.outputs[0].text) for o in generate_within(llm, prompts, sps)]


def _multi_steps():
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    return COUNTERS.get("num_multi_steps")


def test_multi_step_matches_single_step_greedy(model_dir):
    prompts = ["the quick brown ", "once upon", "a"]
    base = _generate(model_dir, 1, prompts, 40)
    before = _multi_steps()
    multi = _generate(model_dir, 4, prompts, 40)
    assert _multi_steps() > before
    assert multi == base
    assert all(len(ids) == 40 for ids, _ in multi)


def test_multi_step_max_tokens_not_multiple_of_n(model_dir):
    base = _generate(model_dir, 1, ["hello wor"], 10)
    multi = _generate(model_dir, 4, ["hello wor"], 10)
    assert multi == base and len(multi[0][0]) == 10


def test_multi_step_crosses_page_boundary(model_dir):
    """48 tokens at 16-slot pages with N = 5: windows straddle pages."""
    base = _generate(model_dir, 1, ["the "], 48)
    multi = _generate(model_dir, 5, ["the "], 48)
    assert multi == base


def test_multi_step_with_logprobs(model_dir):
    from scalellm_tpu_torch import SamplingParams

    got = {}
    for n in (1, 4):
        with _llm(model_dir, n) as llm:
            so = generate_within(llm, ["the quick"], SamplingParams(max_tokens=12, temperature=0.0, logprobs=True,
                                                            top_logprobs=2))[0].outputs[0]
        got[n] = [(lp.token_id, lp.logprob, [(t.token_id, t.logprob) for t in lp.top_logprobs])
                  for lp in so.logprobs]
    assert len(got[4]) == 12
    assert got[4] == got[1]


def test_multi_step_falls_back_for_penalties(model_dir):
    from scalellm_tpu_torch import SamplingParams

    sp = SamplingParams(max_tokens=16, temperature=0.0, repetition_penalty=1.3)
    base = _generate(model_dir, 1, ["the quick"], sp)
    before = _multi_steps()
    multi = _generate(model_dir, 4, ["the quick"], sp)
    assert _multi_steps() == before
    assert multi == base


def test_multi_step_batch_of_mixed_lengths(model_dir):
    from scalellm_tpu_torch import SamplingParams

    sps = [SamplingParams(max_tokens=m, temperature=0.0) for m in (3, 21, 9)]
    prompts = ["the quick", "once upon a time", "hello"]
    base = _generate(model_dir, 1, prompts, sps)
    multi = _generate(model_dir, 4, prompts, sps)
    assert multi == base
    assert [len(ids) for ids, _ in multi] == [3, 21, 9]


def test_padding_page_zero_stays_reserved(model_dir):
    """Micro-steps past a sequence's pages write their KV through the
    block table's zero padding into page 0, which is safe only while page 0
    is never handed out: the allocator refuses to free it, and after a
    multi-step serve it is still held and no sequence's table names it."""
    from scalellm_tpu_torch import SamplingParams
    from scalellm_tpu_torch.memory.block_allocator import BlockAllocator

    alloc = BlockAllocator(8, 16)
    assert alloc.allocate().id == 0
    alloc.reserve(0)
    with pytest.raises(AssertionError):
        alloc.free(0)

    with _llm(model_dir, 4, num_blocks=64) as llm:
        mgr = llm._handler.engine.block_manager
        tables = []
        real = llm._handler.engine.executor.execute_multi

        def execute_multi(mi, si, n, page_size):
            tables.append(mi.block_tables[: int(mi.num_seqs[0])].copy())
            return real(mi, si, n, page_size)

        llm._handler.engine.executor.execute_multi = execute_multi
        generate_within(llm, ["the quick brown", "once"], SamplingParams(max_tokens=21, temperature=0.0))
        assert mgr._padding_block.ref_count >= 1
        assert mgr.num_free_blocks < 64
    assert tables and all((t[:, 0] > 0).all() for t in tables)


def test_multi_step_graphs_on_and_off(model_dir):
    """With graphs on, the warmup captures the N-step graph of each decode
    bucket and the serve replays them (no capture in the serve); graphs off
    runs the same micro-steps as an eager loop. Both give the N = 1 ids."""
    from scalellm_tpu_torch import SamplingParams
    from scalellm_tpu_torch.handlers.llm_handler import LLMHandler, LLMHandlerOptions
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    prompts = ["the quick brown ", "once upon", "a", "xyz"]
    sp = SamplingParams(max_tokens=14, temperature=0.0)
    base = _generate(model_dir, 1, prompts, sp, block_size=4)
    eager = _generate(model_dir, 4, prompts, sp, block_size=4, enable_cuda_graph=False)
    handler = LLMHandler(LLMHandlerOptions(
        model_path=model_dir, devices="cpu", block_size=4, num_blocks=128, num_handling_threads=1,
        num_decode_steps=4, warmup_mode="full", max_tokens_per_batch=32, max_seqs_per_batch=4,
        max_context_len=64))
    try:
        graphs = handler.engine.executor.graphs
        multi_keys = {k for k in graphs.graphs if len(k) > 4}
        # Every decode bucket of the envelope: S = 1, 2, 4 x MAXP = 4, 16.
        assert {k[:3] for k in multi_keys} == {(16, s, p) for s in (1, 2, 4) for p in (4, 16)}
        assert all(k[4:6] == (4, 4) for k in multi_keys)
        compiles = COUNTERS.get("num_mid_serve_compiles")
        outs = []
        for p in prompts:
            handler.schedule_async(p, sp, callback=lambda o: outs.append(o) or True)
        handler.run_until_complete()
        assert COUNTERS.get("num_mid_serve_compiles") == compiles
        assert sum(n for k, n in graphs.replays.items() if k in multi_keys) > 0
        done = {o.prompt: (o.outputs[0].token_ids, o.outputs[0].text) for o in outs if o.finished}
    finally:
        handler.stop()
    assert eager == base
    assert [done[p] for p in prompts] == base


@pytest.fixture(scope="module")
def deepseek():
    from tests.test_torch_cuda_graph import shared_tiny_deepseek

    return shared_tiny_deepseek()


def test_multi_step_deepseek(deepseek):
    prompts = ["the quick brown fox", "abc", "hello"]
    base = _generate(deepseek, 1, prompts, 9, block_size=4)
    before = _multi_steps()
    multi = _generate(deepseek, 4, prompts, 9, block_size=4)
    assert _multi_steps() > before
    assert multi == base


@pytest.fixture(scope="module")
def jax_multi(model_dir):
    """The JAX package's N = 4 serve (its default async scheduling on),
    greedy, run once."""
    from scalellm_tpu import LLM, SamplingParams

    with LLM(model=model_dir, num_blocks=128, block_size=16, enable_prefix_cache=False,
             enable_cuda_graph=False, num_decode_steps=4) as llm:
        outs = generate_within(llm, ["the quick brown ", "once upon", "a"], SamplingParams(max_tokens=18, temperature=0.0))
        return [o.outputs[0].token_ids for o in outs]


def test_multi_step_greedy_matches_jax(model_dir, jax_multi):
    before = _multi_steps()
    got = _generate(model_dir, 4, ["the quick brown ", "once upon", "a"], 18)
    assert _multi_steps() > before
    assert [ids for ids, _ in got] == jax_multi
