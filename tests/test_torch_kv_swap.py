"""KV swap-out preemption (memory/kv_swap.py) against the JAX package's, on
the CPU, after tests/test_kv_swap.py:

- the host pool's byte budget and LRU eviction;
- the executor's page round trip (restore, then fetch, bf16 and int8 pages):
  the same bytes back, other pages untouched, and the cache written in place
  (its data_ptr unchanged: the captured step graphs read that address);
- a serve under tight memory with swap gives the ample-memory serve's ids
  and scalellm_tpu.LLM's under the same options, with async scheduling on
  and off and with int8 pages, and the swap counters move (exact ids: one
  model, greedy);
- the swap-aware victim choice at equal priority: the port's scheduler
  picks the victim the JAX scheduler picks.
"""

import numpy as np
import pytest
import torch

from tests.torch_port_util import generate_within, tiny_llama


def _entry(nbytes: int):
    from scalellm_tpu_torch.memory.kv_swap import SwapEntry

    return SwapEntry(torch.zeros(1, 1, 1, 1, nbytes, dtype=torch.int8), 7)


def test_pool_budget_and_lru():
    from scalellm_tpu_torch.memory.kv_swap import HostKVPool

    pool = HostKVPool(max_bytes=100)
    assert pool.put(1, _entry(40))
    assert pool.put(2, _entry(40))
    assert 1 in pool and 2 in pool
    assert pool.put(3, _entry(40))  # evicts the oldest, seq 1
    assert 1 not in pool and 2 in pool and 3 in pool
    assert pool.used_bytes == 80
    assert not pool.put(4, _entry(200))  # larger than the budget: refused
    e = pool.pop(2)
    assert e is not None and e.num_kv_tokens == 7
    assert pool.used_bytes == 40


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_executor_page_round_trip_is_in_place(kv_cache_dtype):
    import scalellm_tpu_torch.models  # noqa: F401
    from scalellm_tpu_torch.engine.executor import Executor
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry

    loader = HFModelLoader(tiny_llama())
    loader.model_args.kv_cache_dtype = kv_cache_dtype
    model = loader.load_model(ModelRegistry.get_causal_lm_factory("llama")(loader.model_args, device="meta"), "cpu")
    ex = Executor(model, "cpu")
    ex.init_kv_cache(num_blocks=16, block_size=4)
    ptr = ex.kv_cache.data_ptr()
    assert ex.kv_cache.dtype == (torch.int8 if kv_cache_dtype == "int8" else torch.float32)
    shape = list(ex.kv_cache.shape)
    pages = torch.stack([torch.full([shape[0], *shape[2:]], i + 1.0) for i in range(3)], dim=1)
    pages = pages.to(ex.kv_cache.dtype)
    ids = np.asarray([3, 5, 6], np.int32)
    ex.restore_pages(ids, pages)
    assert ex.kv_cache.data_ptr() == ptr
    assert torch.equal(ex.fetch_pages(ids), pages)
    assert torch.equal(ex.fetch_pages_async(ids[::-1].copy()).wait(), pages.flip(1))
    assert torch.all(ex.fetch_pages(np.asarray([1, 2, 4], np.int32)) == 0)
    # Fetched again after a restore into other pages: the same bytes.
    ex.restore_pages(np.asarray([9, 10, 11], np.int32), ex.fetch_pages(ids))
    assert torch.equal(ex.fetch_pages(np.asarray([9, 10, 11], np.int32)), pages)
    assert ex.kv_cache.data_ptr() == ptr


PROMPTS = [f"prompt {i} " + "x" * 24 for i in range(4)]


def _generate(llm_cls, sp_cls, host_swap_bytes, num_blocks, **kw):
    llm = llm_cls(tiny_llama(), block_size=4, num_blocks=num_blocks, enable_prefix_cache=False,
                  host_swap_bytes=host_swap_bytes, max_seqs_per_batch=8, **kw)
    try:
        outs = generate_within(llm, PROMPTS, sp_cls(temperature=0.0, max_tokens=16, ignore_eos=True))
        return [tuple(o.outputs[0].token_ids) for o in outs]
    finally:
        llm.close()


# name -> the options of both serves
SWAP_CASES = {
    "async": dict(),
    "sync": dict(enable_async_scheduling=False),
    "int8": dict(kv_cache_dtype="int8"),
}


@pytest.mark.parametrize("case", list(SWAP_CASES))
def test_tight_memory_with_swap_gives_the_ample_ids_and_jax_ids(case):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    kw = SWAP_CASES[case]
    want = _generate(LLM, SamplingParams, 0, 256, devices="cpu", **kw)  # ample memory: no preemption
    before = {c: COUNTERS.get(c) for c in ("num_swap_out", "num_swap_in", "num_preempted_requests")}
    got = _generate(LLM, SamplingParams, 64 << 20, 40, devices="cpu", **kw)
    moved = {c: COUNTERS.get(c) - v for c, v in before.items()}
    assert got == want
    assert moved["num_swap_out"] > 0 and moved["num_swap_in"] > 0 and moved["num_preempted_requests"] > 0
    assert got == _generate(JaxLLM, JaxSamplingParams, 64 << 20, 40, enable_cuda_graph=False, **kw)
    # Tight memory without swap (re-prefill): the same ids.
    assert _generate(LLM, SamplingParams, 0, 40, devices="cpu", **kw) == want


class _StubSwapper:
    """Says which sequences' pages fit the pool, records the swap-outs and
    stages nothing (the victims then re-prefill)."""

    def __init__(self):
        self.fits, self.swapped = {}, []

    def has_entry(self, seq):
        return False

    def staging_fits(self, seq):
        return self.fits.get(seq.request.prompt, True)

    def swap_out(self, seq):
        self.swapped.append(seq.request.prompt)
        return False

    def finalize_staging(self):
        pass

    def discard(self, seq):
        pass


def _victim(pkg):
    """The first victim `pkg`'s scheduler stages when a HIGH request needs
    the blocks of two LOW requests of which only the older one's pages fit
    the pool (plain lowest-priority-youngest-first would take the younger)."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    BlockManager, Opts = mod("memory.block_manager").BlockManager, mod("memory.block_manager").BlockManagerOptions
    Priority = mod("request.output").Priority
    sched_mod = mod("scheduler.continuous_scheduler")
    from tests.test_scheduler import FakeTokenizer

    class Engine:
        def __init__(self):
            self.tokenizer = FakeTokenizer()
            self.block_manager = BlockManager(Opts(num_blocks=12, block_size=4))
            self.kv_swapper = _StubSwapper()

        def execute_model(self, batch):
            for e in batch.entries:
                tok = e.seq.num_tokens % 256
                e.seq.commit_kv_cache(e.num_tokens)
                if e.needs_sample:
                    e.seq.append_token(tok)

    def request(prompt, max_tokens, priority, outs):
        tok = FakeTokenizer()
        return mod("request.request").Request(
            prompt=prompt, prompt_tokens=tok.encode(prompt),
            sampling_params=mod("sampling.params").SamplingParams(max_tokens=max_tokens, temperature=0.0),
            stopping_criteria=mod("request.stopping").StoppingCriteria(max_tokens=max_tokens, eos_token_id=-1),
            on_output=outs.append, stream=False, priority=priority)

    engine = Engine()
    sched = sched_mod.ContinuousScheduler(
        engine, sched_mod.SchedulerOptions(max_seqs_per_batch=8, enable_async_scheduling=False),
        response_handler=mod("scheduler.response_handler").ResponseHandler(engine.tokenizer, threaded=False))
    outs = []
    older = request("b" * 16, 8, Priority.LOW, outs)
    younger = request("a" * 16, 8, Priority.LOW, outs)
    sched.schedule(older)
    sched.schedule(younger)
    sched.step()  # both prefill, holding blocks
    engine.kv_swapper.fits = {younger.prompt: False, older.prompt: True}
    sched.schedule(request("c" * 24, 1, Priority.HIGH, outs))
    sched.step()
    sched.run_until_complete()
    assert len(outs) == 3 and all(o.finished for o in outs)
    return engine.kv_swapper.swapped[0]


def test_swap_aware_victim_choice_matches_jax():
    assert _victim("scalellm_tpu_torch") == _victim("scalellm_tpu") == "b" * 16
