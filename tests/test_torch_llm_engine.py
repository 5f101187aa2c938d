"""The port's AsyncLLMEngine and its output streams (llm_engine.py), the
model-args overrides (utils/args_override.py) and the environment report
(utils/collect_env.py), against the JAX package on the CPU:

- AsyncLLMEngine's streamed deltas and final texts equal scalellm_tpu's
  AsyncLLMEngine's for the same greedy prompts;
- OutputStream and OutputAsyncStream behave as the reference's on a cancel,
  an error status and the end of a stream;
- a cancelled stream's request is retired and its blocks come back;
- lora_names, and a request by adapter name;
- apply_overrides gives the reference's ModelArgs and applied list and
  refuses what it refuses; an LLM with an override gives the JAX package's
  greedy text under the same override;
- stop() drops the engine;
- collect_env runs in a fresh interpreter and loads no jax.
"""

import asyncio
import dataclasses
import json
import subprocess
import sys
import time

import pytest

from tests.torch_port_util import generate_within, lora_dims, make_lora_adapter, tiny_llama

PROMPTS = ["hello world", "abcdef", "xyz xyz xyz", "the quick brown fox", "q"]
DEADLINE_S = 300


def _engine(pkg: str, **kw):
    mod = __import__(pkg, fromlist=["x"])
    if pkg == "scalellm_tpu_torch":
        kw.setdefault("devices", "cpu")
    return mod.AsyncLLMEngine(tiny_llama(), block_size=4, num_blocks=128, enable_cuda_graph=False, **kw)


async def _serve(engine, sp_cls, stream: bool):
    """Every prompt at once; per prompt the concatenated text of its
    outputs (a stream's deltas) and the number of items."""
    sp = sp_cls(max_tokens=16, temperature=0.0, ignore_eos=True)
    streams = [await engine.schedule_async(p, sp, stream=stream) for p in PROMPTS]

    async def drain(s):
        texts = [out.outputs[0].text async for out in s if out.outputs]
        return "".join(texts), len(texts)

    return await asyncio.wait_for(asyncio.gather(*(drain(s) for s in streams)), DEADLINE_S)


def _run(pkg: str, streams=(False, True)):
    """{stream: _serve's result} of one engine of package `pkg`."""
    mod = __import__(pkg, fromlist=["x"])
    engine = _engine(pkg)
    engine.start()
    try:
        return {s: asyncio.run(_serve(engine, mod.SamplingParams, s)) for s in streams}
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def jax_runs():
    return _run("scalellm_tpu")


@pytest.mark.parametrize("stream", [True, False])
def test_async_engine_texts_equal_the_jax_engines(jax_runs, stream):
    """Final texts, and a stream's deltas put together, equal the JAX
    engine's; streams deliver several items (how many depends on when the
    response thread runs), a plain request one."""
    got = _run("scalellm_tpu_torch", (stream,))[stream]
    texts = [t for t, _ in got]
    assert texts == [t for t, _ in jax_runs[stream]] == [t for t, _ in jax_runs[not stream]]
    items = [n for _, n in got]
    assert sum(items) > len(items) if stream else items == [1] * len(items)


# ------------------------------------------------------------ the streams


def _outputs(pkg: str):
    """A stream's items in package `pkg`'s types: two deltas, an error, the
    end."""
    out = __import__(f"{pkg}.request.output", fromlist=["x"])
    ok = out.Status(out.StatusCode.OK)
    return [out.RequestOutput(status=ok, outputs=[out.SequenceOutput(index=0, text="a")]),
            out.RequestOutput(status=ok, outputs=[out.SequenceOutput(index=0, text="b")], finished=True),
            out.RequestOutput(status=out.Status(out.StatusCode.INVALID_ARGUMENT, "bad"), finished=True)]


def _sync_stream(pkg: str, case: str):
    mod = __import__(f"{pkg}.llm_engine", fromlist=["x"])
    a, b, err = _outputs(pkg)
    s = mod.OutputStream()
    puts = []
    if case == "end":
        puts = [s.put(a), s.put(b)]
    elif case == "error":
        puts = [s.put(a), s.put(err)]
    else:  # cancel after the first item
        puts = [s.put(a)]
        s.cancel()
        puts.append(s.put(b))
    got = []
    try:
        for item in s:
            got.append(item.outputs[0].text)
    except Exception as e:
        got.append((type(e).__name__, e.code.name, e.message))
    return puts, got


async def _async_stream(pkg: str, case: str):
    mod = __import__(f"{pkg}.llm_engine", fromlist=["x"])
    a, b, err = _outputs(pkg)
    s = mod.OutputAsyncStream(asyncio.get_running_loop())
    if case == "end":
        puts = [s.put(a), s.put(b)]
    elif case == "error":
        puts = [s.put(a), s.put(err)]
    else:
        puts = [s.put(a)]
        s.cancel()
        puts.append(s.put(b))
    got = []
    try:
        async for item in s:
            got.append(item.outputs[0].text)
    except Exception as e:
        got.append((type(e).__name__, e.code.name, e.message))
    return puts, got


@pytest.mark.parametrize("kind", ["sync", "async"])
@pytest.mark.parametrize("case", ["end", "error", "cancel"])
def test_streams_behave_as_the_reference(kind, case):
    def run(pkg):
        if kind == "sync":
            return _sync_stream(pkg, case)
        return asyncio.run(asyncio.wait_for(_async_stream(pkg, case), 30))

    got, want = run("scalellm_tpu_torch"), run("scalellm_tpu")
    assert got == want
    puts, items = got
    assert {"end": items == ["a", "b"] and puts == [True, True],
            "error": items == ["a", ("ValidationError", "INVALID_ARGUMENT", "bad")] and puts == [True, False],
            "cancel": items == ["a"] and puts == [True, False]}[case]


def _free(engine):
    bm = engine._handler.engine.block_manager
    return bm.num_free_blocks + bm.num_blocks_in_prefix_cache


def test_cancelled_stream_is_retired_and_frees_its_blocks():
    from scalellm_tpu_torch import SamplingParams

    engine = _engine("scalellm_tpu_torch")
    engine.start()
    try:
        before = _free(engine)
        stream = engine.schedule("a long one", SamplingParams(max_tokens=400, temperature=0.0, ignore_eos=True),
                                 stream=True)
        for i, _ in enumerate(stream):
            if i == 2:
                stream.cancel()
        deadline = time.monotonic() + DEADLINE_S
        while _free(engine) != before or engine._handler.scheduler._requests:
            assert time.monotonic() < deadline, "the cancelled request kept its blocks"
            time.sleep(0.02)
        # The engine serves on after it.
        out = list(engine.schedule("after", SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)))
        assert out[-1].finished and out[-1].status.ok and out[-1].usage.num_generated_tokens == 4
    finally:
        engine.stop()
    assert engine._handler is None


def test_lora_names_and_a_request_by_adapter(tmp_path):
    from scalellm_tpu_torch import SamplingParams, ValidationError
    from scalellm_tpu_torch.config import ModelArgs
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader

    args = HFModelLoader(tiny_llama()).model_args
    assert isinstance(args, ModelArgs)
    dims = lora_dims(args)
    modules = {name: str(tmp_path / name) for name in ("b", "a")}
    for i, d in enumerate(modules.values()):
        make_lora_adapter(d, dims, args.n_layers, seed=i)
    engine = _engine("scalellm_tpu_torch", lora_modules=modules)
    engine.start()
    try:
        assert engine.lora_names == ["b", "a"]
        sp = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)

        async def go():
            ok = [o async for o in await engine.schedule_async("hi", sp, lora="a")]
            with pytest.raises(ValidationError):
                [o async for o in await engine.schedule_async("hi", sp, lora="nope")]
            return ok

        outs = asyncio.run(asyncio.wait_for(go(), DEADLINE_S))
        assert outs[-1].status.ok and outs[-1].usage.num_generated_tokens == 4
    finally:
        engine.stop()
    plain = _engine("scalellm_tpu_torch")
    assert plain.lora_names == []
    plain.stop()


def test_mesh_is_not_ported():
    from scalellm_tpu_torch import AsyncLLMEngine

    with pytest.raises(NotImplementedError):
        AsyncLLMEngine(tiny_llama(), devices="cpu", mesh=object())


# ------------------------------------------------------------ overrides

OVERRIDES = [["rope_theta=500"], ["rms_norm_eps=1e-3", "max_position_embeddings=1024"], ["n_kv_heads=2"],
             ["tie_word_embeddings=false"], ["stop_token_ids=[5, 9]"], []]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: ",".join(o) or "none")
def test_apply_overrides_equals_the_reference(overrides):
    from scalellm_tpu.model_loader.loader import HFModelLoader as RefLoader
    from scalellm_tpu.utils.args_override import apply_overrides as ref_apply
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.utils.args_override import apply_overrides

    got, want = HFModelLoader(tiny_llama()).model_args, RefLoader(tiny_llama()).model_args
    assert apply_overrides(got, overrides) == ref_apply(want, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("bad", ["rope_theta", "no_such_field=1", "quant_args.bits=8", "tie_word_embeddings=maybe",
                                 "rope_theta=fast"])
def test_apply_overrides_refuses_what_the_reference_refuses(bad):
    from scalellm_tpu.model_loader.loader import HFModelLoader as RefLoader
    from scalellm_tpu.utils.args_override import apply_overrides as ref_apply
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.utils.args_override import apply_overrides

    with pytest.raises(ValueError):
        ref_apply(RefLoader(tiny_llama()).model_args, [bad])
    with pytest.raises(ValueError):
        apply_overrides(HFModelLoader(tiny_llama()).model_args, [bad])


def test_llm_with_an_override_gives_the_jax_packages_text():
    """rope_theta changed at load: the port's LLM against the JAX engine
    under the same override, and against the port without it."""
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams

    override = ["rope_theta=25.0"]
    sp = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
    llm = LLM(tiny_llama(), devices="cpu", block_size=4, num_blocks=128, model_args_overrides=override)
    plain = LLM(tiny_llama(), devices="cpu", block_size=4, num_blocks=128)
    try:
        assert llm._handler.engine.applied_model_args_overrides == ["rope_theta=25.0"]
        assert llm._handler.engine.model_args.rope_theta == 25.0
        got = [o.outputs[0].token_ids for o in generate_within(llm, PROMPTS, SamplingParams(**sp))]
        base = [o.outputs[0].token_ids for o in generate_within(plain, PROMPTS, SamplingParams(**sp))]
    finally:
        llm.close()
        plain.close()
    assert got != base  # the override reached the model
    jax_engine = _engine("scalellm_tpu", model_args_overrides=override)
    jax_engine.start()
    try:
        want = [list(jax_engine.schedule(p, JaxSamplingParams(**sp)))[-1].outputs[0].token_ids for p in PROMPTS]
    finally:
        jax_engine.stop()
    assert got == want


# ------------------------------------------------------------ collect_env


def test_collect_env_loads_no_jax():
    code = ("import json, sys\n"
            "from scalellm_tpu_torch.utils.collect_env import collect_env\n"
            "info = collect_env()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'scalellm_tpu')]\n"
            "print(json.dumps({'info': info, 'bad': bad}, default=str))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    info = res["info"]
    for key in ("python", "platform", "torch", "torch_cuda", "cuda_available", "devices", "nvcc", "numpy", "triton"):
        assert key in info, key
    assert info["python"] == sys.version.split()[0]
