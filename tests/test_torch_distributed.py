"""The port's driver/follower engine (scalellm_tpu_torch/engine/
distributed.py) and its multi-process plumbing (parallel/multihost.py),
mirroring tests/test_distributed.py and tests/test_multihost.py: the
pass-through on one process, a 2-process broadcast of a step's inputs, the
header's desync check, a scripted follower loop (stop and heartbeat
headers), the follower's watchdog on a wedged driver; then whole serves at
tp 2 over gloo on the CPU (LLM, AsyncLLMEngine, the REST server, two
--coordinator hosts) whose greedy texts equal the port's tp 1 and the JAX
package's, a killed follower making the driver raise, and the options
refused with tp > 1."""

import asyncio
import json
import re
import types

import numpy as np
import pytest

from tests.torch_port_util import (
    free_port,
    generate_within,
    http_ok,
    output,
    spawn,
    stop_all,
    tiny_llama,
    wait_ready,
)
from tests.test_torch_parallel import run_world

# The serves' options: tensor parallelism runs eagerly and synchronously.
TP_KW = dict(devices="cpu", block_size=4, num_blocks=300, enable_cuda_graph=False, enable_async_scheduling=False)
PROMPTS = ["hello world", "the quick brown fox", "abc", "tensor parallel"]
# A killed follower: the driver's next step raises within this many seconds.
DEATH_S = 30


def _sp(**kw):
    from scalellm_tpu_torch import SamplingParams

    return SamplingParams(**{"max_tokens": 8, "temperature": 0.0, "ignore_eos": True, **kw})


# ------------------------------------------------------------ plumbing


def test_broadcast_passthrough_single_process():
    from scalellm_tpu_torch.parallel import multihost

    mi = {"a": np.arange(4), "b": np.ones((2, 2))}
    (out,) = multihost.broadcast_step_inputs(mi)
    assert out is mi


def test_pod_mesh_single_process():
    from scalellm_tpu_torch.parallel import multihost

    mesh = multihost.make_pod_mesh(device="cpu")
    assert (mesh.tp_size, mesh.dp_size, mesh.tp_group) == (1, 1, None)
    assert multihost.collective_smoke_test(mesh)
    assert multihost.is_driver()


def test_broadcast_with_timeout_single_process():
    from scalellm_tpu_torch.parallel import multihost

    x = np.arange(3)
    assert multihost.broadcast_with_timeout(x, timeout=5.0) is x


def test_distributed_engine_single_process():
    """DistributedLLMEngine is LLMEngine on one process."""
    from scalellm_tpu_torch.engine.batch import Batch
    from scalellm_tpu_torch.engine.distributed import DistributedLLMEngine
    from scalellm_tpu_torch.engine.llm_engine import EngineOptions
    from scalellm_tpu_torch.request.sequence import Sequence
    from scalellm_tpu_torch.request.stopping import StoppingCriteria
    from scalellm_tpu_torch.sampling.params import SamplingParams

    eng = DistributedLLMEngine(EngineOptions(model_path=tiny_llama(), device="cpu", num_blocks=64, block_size=4,
                                             enable_cuda_graph=False))
    assert eng.supports_async and eng.supports_multi_step
    seq = Sequence(0, [1, 2, 3], SamplingParams(temperature=0.0), StoppingCriteria())
    assert eng.block_manager.allocate_blocks_for(seq, 4)
    b = Batch()
    b.add(seq, 3)
    eng.execute_model(b)
    assert seq.num_tokens == 4  # one token sampled
    # On the CPU no kernel launches: every count is 0, and reset keeps it so.
    from scalellm_tpu_torch.ops import kernel_counters

    counts = eng.rank_launches(reset=True)
    assert len(counts) == 1 and set(counts[0]) == set(kernel_counters()) and not any(counts[0].values())
    eng.close()


def test_check_step_header_desync():
    from scalellm_tpu_torch.engine import distributed as D

    h = np.zeros(D._HEADER_LEN, np.int32)
    h[0], h[8] = 1, 7
    D.check_step_header(h, 7)  # in sync: no raise
    with pytest.raises(RuntimeError, match="desync"):
        D.check_step_header(h, 6)


def _mk_header(step, flag=1, T=4, S=2):
    from scalellm_tpu_torch.engine import distributed as D

    h = np.zeros(D._HEADER_LEN, np.int32)
    h[0], h[1], h[2], h[3], h[4], h[5], h[7] = flag, T, S, 1, 1, 1, 1
    h[8] = step
    return h


def _run_follower_scripted(monkeypatch, headers):
    """Drive DistributedLLMEngine.run_follower with a scripted broadcast
    sequence (no processes); returns the steps it ran, as (T, S,
    decode_only)."""
    from scalellm_tpu_torch.engine import distributed as D
    from scalellm_tpu_torch.parallel import multihost

    script = list(headers)
    monkeypatch.setattr(multihost, "is_driver", lambda: False)
    monkeypatch.setattr(multihost, "broadcast_with_timeout", lambda z, timeout=None: script.pop(0))
    # payload broadcast: followers receive their placeholders unchanged
    monkeypatch.setattr(multihost, "broadcast_step_inputs", lambda *p: p)
    executed = []
    dummy = types.SimpleNamespace(_multi=True, executor=types.SimpleNamespace(
        execute=lambda mi, si, decode_only=False: executed.append(
            (mi.token_ids.shape[0], si.seeds.shape[0], decode_only))))
    D.DistributedLLMEngine.run_follower(dummy)
    return executed


def test_run_follower_heartbeat_and_stop(monkeypatch):
    """Heartbeats keep the loop alive without advancing the step counter;
    each step runs on placeholders of the header's bucket."""
    from scalellm_tpu_torch.engine import distributed as D

    ran = _run_follower_scripted(monkeypatch, [
        _mk_header(1),
        _mk_header(0, flag=D._HEARTBEAT),  # idle keep-alive: skipped
        _mk_header(2, T=16, S=4),
        _mk_header(0, flag=D._STOP),
    ])
    assert ran == [(4, 2, False), (16, 4, False)]


def test_run_follower_desync_aborts(monkeypatch):
    """A skipped broadcast (driver ahead of follower) fails loudly before
    entering a mismatched collective."""
    with pytest.raises(RuntimeError, match="desync"):
        _run_follower_scripted(monkeypatch, [_mk_header(1), _mk_header(5)])


def test_two_process_broadcast_and_watchdog(tmp_path):
    """Two gloo processes: rank 1 receives rank 0's step inputs bit for bit
    (every field of ModelInputs and SamplingInputs, the guided mask and the
    uint32 seeds included); then, with rank 0 alive but silent, rank 1's
    broadcast_with_timeout raises after its 3 s instead of waiting forever."""
    from scalellm_tpu_torch.engine import distributed as D

    header = _mk_header(1, T=16, S=4)
    header[4], header[5], header[7] = 3, 2, 5
    cases = [dict(kind="broadcast", name="b", header=header.tolist(), seed=3),
             dict(kind="wedged", name="w", hold=8, timeout=3.0)]
    r0, r1 = run_world(tmp_path, "bcast", 2, cases)
    b_keys = [k for k in r0 if k.startswith("b/")]
    assert len(b_keys) == 22
    mi, si = D._placeholders(header)
    assert r1["b/allowed_mask"].dtype == np.uint32 and r1["b/allowed_mask"].shape == si.allowed_mask.shape
    for k in b_keys:
        assert r0[k].dtype == r1[k].dtype and np.array_equal(r0[k], r1[k]), k
    assert np.any(r0["b/seeds"] != 0)
    assert int(r1["w"]) == 1


def test_rank_devices_and_backend():
    from scalellm_tpu_torch.engine.distributed import backend_for, rank_devices

    assert rank_devices("cpu", 2) == ["cpu", "cpu"]
    assert rank_devices("cuda:0,cuda:0", 2) == ["cuda:0", "cuda:0"]
    with pytest.raises(ValueError, match="one a rank"):
        rank_devices("cuda:0", 2)
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"  # ranks share a card
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    with pytest.raises(ValueError):
        backend_for(["cpu", "cuda:0"])


# ------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def tp1_texts():
    from scalellm_tpu_torch import LLM

    llm = LLM(tiny_llama(), **TP_KW)
    try:
        return [o.outputs[0].text for o in generate_within(llm, PROMPTS, _sp())]
    finally:
        llm.close()


@pytest.fixture(scope="module")
def jax_texts():
    from scalellm_tpu import LLM, SamplingParams

    llm = LLM(tiny_llama(), block_size=4, num_blocks=300)
    try:
        sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
        return [o.outputs[0].text for o in generate_within(llm, PROMPTS, sp)]
    finally:
        close = getattr(llm, "close", None)
        if close:
            close()


def _serve_twice(llm):
    """Greedy texts of PROMPTS, then the outputs of a sampled request (a
    seed, logprobs), a guided one (its mask rides the broadcast) and a
    top-k one; a step's seeds depend on the engine's step count, so both
    engines compared serve the same history."""
    try:
        greedy = [o.outputs[0].text for o in generate_within(llm, PROMPTS, _sp())]
        extra = [_sp(temperature=0.8, seed=11, logprobs=True, top_logprobs=2),
                 _sp(guided_regex="(yes|no)+", max_tokens=6), _sp(top_k=5, temperature=1.0, seed=3)]
        return greedy, generate_within(llm, PROMPTS[:3], extra)
    finally:
        llm.close()


@pytest.mark.parametrize("sp", [False, True])
def test_llm_tp2_generates_the_tp1_and_jax_texts(tp1_texts, jax_texts, sp):
    """LLM(tp_size=2) greedy texts equal tp 1's and the JAX package's; the
    sampled, guided and top-k requests after them give tp 1's ids, texts
    and logprobs."""
    from scalellm_tpu_torch import LLM

    got, mixed = _serve_twice(LLM(tiny_llama(), tp_size=2, sequence_parallel=sp, **TP_KW))
    assert got == tp1_texts == jax_texts
    _, want = _serve_twice(LLM(tiny_llama(), **TP_KW))
    for g, w in zip(mixed, want):
        assert g.outputs[0].token_ids == w.outputs[0].token_ids
        assert g.outputs[0].text == w.outputs[0].text
    assert re.fullmatch("(yes|no)+", mixed[1].outputs[0].text.rstrip("\x02"))  # \x02: the eos char
    assert [lp.token for lp in mixed[0].outputs[0].logprobs] == [lp.token for lp in want[0].outputs[0].logprobs]
    np.testing.assert_allclose([lp.logprob for lp in mixed[0].outputs[0].logprobs],
                               [lp.logprob for lp in want[0].outputs[0].logprobs], atol=1e-4)


def test_prompt_logprobs_are_refused_under_tp():
    """Prompt scoring is a step the followers do not run: refused at the
    front door (INVALID_ARGUMENT), and the engine keeps serving."""
    from scalellm_tpu_torch import LLM

    llm = LLM(tiny_llama(), tp_size=2, **TP_KW)
    try:
        bad, ok = generate_within(llm, PROMPTS[:2], [_sp(prompt_logprobs=1), _sp()])
        # Both ranks answer the counts header (all 0: no kernel runs on the CPU).
        counts = llm._handler.engine.rank_launches()
        assert len(counts) == 2 and counts[0] == counts[1] and not any(counts[0].values())
    finally:
        llm.close()
    assert bad.status.code.name == "INVALID_ARGUMENT" and "prompt_logprobs" in bad.status.message
    assert ok.status.ok and len(ok.outputs[0].token_ids) == 8


def test_a_killed_follower_makes_the_driver_raise():
    """A follower that dies: the driver's next step raises (within DEATH_S),
    and close() reports the follower's exit code."""
    import time

    from scalellm_tpu_torch import LLM

    llm = LLM(tiny_llama(), tp_size=2, **TP_KW)
    follower = llm._handler.engine._followers[0]
    follower.kill()
    follower.join(10)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="follower rank 1"):
        generate_within(llm, PROMPTS[:1], _sp(), seconds=DEATH_S)
    assert time.monotonic() - t0 < DEATH_S
    with pytest.raises(RuntimeError, match="exited with code"):
        llm.close()


def test_async_engine_tp2_streams_the_tp1_text(tp1_texts):
    from scalellm_tpu_torch import AsyncLLMEngine

    engine = AsyncLLMEngine(tiny_llama(), tp_size=2, **TP_KW)

    async def go():
        texts = []
        for p in PROMPTS:
            stream = await engine.schedule_async(p, _sp(), stream=True)
            texts.append("".join([o.outputs[0].text async for o in stream]))
        return texts

    engine.start()
    try:
        got = asyncio.run(asyncio.wait_for(go(), 120))
    finally:
        engine.stop()
    assert got == tp1_texts


def _complete(base, prompt):
    import urllib.request

    body = json.dumps({"prompt": prompt, "max_tokens": 8, "temperature": 0.0, "ignore_eos": True}).encode()
    req = urllib.request.Request(base + "/v1/completions", body, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["choices"][0]["text"]


SERVER = "scalellm_tpu_torch.serve.api_server"
SERVER_FLAGS = ("--devices", "cpu", "--host", "127.0.0.1", "--num-blocks", "300", "--block-size", "4",
                "--disable-warmup", "--disable-async-scheduling")


@pytest.mark.parametrize("how", ["tp_size", "coordinator"])
def test_api_server_tp2_answers_with_the_tp1_text(tp1_texts, how):
    """The REST server at --tp-size 2 (it starts its follower), and as two
    --coordinator hosts (host 1 follows and serves no HTTP): /v1/completions
    gives the tp 1 texts, and SIGTERM stops every process with code 0."""
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    common = ("--model", tiny_llama(), "--port", str(port), *SERVER_FLAGS)
    if how == "tp_size":
        procs = [spawn(SERVER, *common, "--tp-size", "2")]
    else:
        world = ("--coordinator", f"127.0.0.1:{free_port()}", "--num-hosts", "2")
        procs = [spawn(SERVER, *common, *world, "--host-id", str(h)) for h in (0, 1)]
    try:
        wait_ready(procs, lambda: http_ok(base + "/health"), "tp api server")
        got = [_complete(base, p) for p in PROMPTS]
    finally:
        codes = stop_all(procs[:1], seconds=30)
        if len(procs) > 1:  # the follower exits on host 0's stop header
            codes += [procs[1].wait(timeout=30)]
    assert got == tp1_texts
    assert codes == [0] * len(procs), [output(p)[-3000:] for p in procs]


def test_check_ported_refuses_what_tp_does_not_carry():
    from scalellm_tpu_torch.handlers.llm_handler import LLMHandlerOptions

    base = dict(enable_cuda_graph=False, enable_async_scheduling=False)
    for parallel in (dict(tp_size=2), dict(distributed=True), dict(tp_size=2, sequence_parallel=True)):
        LLMHandlerOptions(**parallel, **base).check_ported()
        for option, word in ((dict(enable_cuda_graph=True), "enable_cuda_graph"),
                             (dict(enable_async_scheduling=True), "enable_async_scheduling"),
                             (dict(num_decode_steps=4), "num_decode_steps"),
                             (dict(num_speculative_tokens=2), "speculative decoding"),
                             (dict(draft_model_path="d", num_speculative_tokens=2), "speculative decoding"),
                             (dict(host_swap_bytes=1), "host_swap_bytes")):
            with pytest.raises(NotImplementedError, match=word):
                LLMHandlerOptions(**{**base, **parallel, **option}).check_ported()
        with pytest.raises(ValueError, match="LoRA"):
            LLMHandlerOptions(lora_modules={"a": "b"}, **parallel, **base).check_ported()
    with pytest.raises(ValueError, match="tp_size"):
        LLMHandlerOptions(tp_size=0).check_ported()


def test_mla_and_devices_refusals(tmp_path):
    """DeepSeek-V2's MLA model refuses tp; devices='auto' needs a card a
    rank; neither starts a follower that is left behind."""
    from scalellm_tpu_torch.config import ModelArgs
    from scalellm_tpu_torch.engine.distributed import rank_devices
    from scalellm_tpu_torch.models.deepseek import MLADecoderModel
    from scalellm_tpu_torch.parallel import ParallelConfig

    args = ModelArgs(model_type="deepseek_v2", dtype="float32", hidden_size=64, n_layers=1, n_heads=4,
                     n_kv_heads=4, vocab_size=128, kv_lora_rank=16, q_lora_rank=0)
    with pytest.raises(NotImplementedError, match="tp_size"):
        MLADecoderModel(args, device="meta", parallel=ParallelConfig(tp_size=2))
    with pytest.raises(RuntimeError, match="cards"):
        rank_devices("auto", 2)
