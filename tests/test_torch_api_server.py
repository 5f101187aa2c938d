"""The port's OpenAI server (scalellm_tpu_torch/serve/api_server.py) as a
subprocess on the CPU (`--devices cpu`): tests/test_api_server.py's 12
tests mirrored against it, then what the port adds to hold:

- greedy /v1/completions texts equal to scalellm_tpu.LLM's on the same tiny
  checkpoint;
- /config: the handler's options from the flags, and the model args equal
  to the JAX package's loader's;
- /profile/start and /profile/stop write a torch.profiler trace of the
  engine's steps;
- --tp-size 2 (with --sequence-parallel) and --coordinator without
  --disable-async-scheduling refused before the model loads or a world is
  joined, with a non-zero exit and the refusal's message naming the option
  (tests/test_torch_distributed.py serves with them);
- SIGTERM stops the server with exit code 0.
"""

import json
import signal
import time
import urllib.error
import urllib.request

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

MODULE = "scalellm_tpu_torch.serve.api_server"
FLAGS = ("--devices", "cpu", "--host", "127.0.0.1", "--num-blocks", "300", "--block-size", "4",
         "--disable-warmup")


def _start(*extra):
    port = free_port()
    proc = spawn(MODULE, "--model", tiny_llama(), "--port", str(port), *FLAGS, *extra)
    base = f"http://127.0.0.1:{port}"
    try:
        wait_ready([proc], lambda: http_ok(base + "/health"), "api server")
    except BaseException:
        stop_all([proc])
        raise
    return proc, base


@pytest.fixture(scope="module")
def server():
    proc, base = _start()
    try:
        yield base
    finally:
        stop_all([proc])


def _post(base, path, payload, timeout=120):
    req = urllib.request.Request(
        base + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _sse(base, path, payload):
    """The JSON chunks of an SSE response, up to [DONE]."""
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers.get("Content-Type", "").startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                data = line[len("data: "):]
                if data == "[DONE]":
                    break
                chunks.append(json.loads(data))
    return chunks


# ------------------------------------------- tests/test_api_server.py, mirrored


def test_models(server):
    with urllib.request.urlopen(server + "/v1/models", timeout=10) as r:
        body = json.loads(r.read())
    assert body["object"] == "list"
    assert len(body["data"]) == 1


def test_completion(server):
    status, body = _post(server, "/v1/completions", {"model": "m", "prompt": "hello", "max_tokens": 4,
                                                     "temperature": 0.0, "ignore_eos": True})
    assert status == 200
    assert body["object"] == "text_completion"
    assert len(body["choices"]) == 1
    assert body["usage"]["completion_tokens"] == 4
    assert body["choices"][0]["finish_reason"] == "length"


def test_completion_streaming(server):
    chunks = _sse(server, "/v1/completions", {"model": "m", "prompt": "abc", "max_tokens": 4, "temperature": 0.0,
                                              "ignore_eos": True, "stream": True})
    assert chunks, "no SSE chunks received"
    text = "".join(c["choices"][0]["text"] for c in chunks)
    assert len(text) > 0
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    # The finish reason goes out once, in the last chunk.
    assert [c["choices"][0]["finish_reason"] for c in chunks[:-1]] == [None] * (len(chunks) - 1)
    status, body = _post(server, "/v1/completions", {"model": "m", "prompt": "abc", "max_tokens": 4,
                                                     "temperature": 0.0, "ignore_eos": True})
    assert body["choices"][0]["text"] == text


def test_chat_completion(server):
    status, body = _post(server, "/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "temperature": 0.0,
        "ignore_eos": True})
    assert status == 200
    assert body["object"] == "chat.completion"
    assert body["choices"][0]["message"]["role"] == "assistant"
    assert body["usage"]["completion_tokens"] == 4


def test_validation_error(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/v1/completions", {"model": "m", "prompt": "x", "max_tokens": 0})
    assert e.value.code == 400
    assert "max_tokens" in json.loads(e.value.read())["error"]["message"]


def test_metrics_endpoint(server):
    with urllib.request.urlopen(server + "/metrics", timeout=10) as r:
        text = r.read().decode()
    assert "# TYPE" in text
    assert "request_handling_total" in text


def test_concurrent_clients(server):
    import concurrent.futures

    def one(i):
        status, body = _post(server, "/v1/completions", {"model": "m", "prompt": f"client {i} says",
                                                         "max_tokens": 3, "temperature": 0.0, "ignore_eos": True})
        assert status == 200
        return body["choices"][0]["text"]

    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        texts = list(pool.map(one, range(6)))
    assert len(texts) == 6
    assert all(len(t) > 0 for t in texts)


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get weather for a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string", "maxLength": 12}},
                   "required": ["city"]}}}]


def test_chat_tool_call_forced(server):
    status, body = _post(server, "/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "weather?"}], "max_tokens": 160,
        "temperature": 1.0, "tools": TOOLS, "tool_choice": "required"})
    assert status == 200
    choice = body["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    calls = choice["message"]["tool_calls"]
    assert calls[0]["function"]["name"] == "get_weather"
    assert isinstance(json.loads(calls[0]["function"]["arguments"])["city"], str)


def test_chat_tool_call_streaming(server):
    chunks = _sse(server, "/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "weather?"}], "max_tokens": 160,
        "temperature": 1.0, "stream": True, "tools": TOOLS,
        "tool_choice": {"type": "function", "function": {"name": "get_weather"}}})
    tool_deltas = [tc for c in chunks for tc in c["choices"][0]["delta"].get("tool_calls", [])]
    finishes = [c["choices"][0]["finish_reason"] for c in chunks if c["choices"][0]["finish_reason"]]
    assert finishes == ["tool_calls"]
    assert tool_deltas[0]["function"]["name"] == "get_weather"
    json.loads(tool_deltas[0]["function"]["arguments"])


def test_chat_tool_result_roundtrip(server):
    status, body = _post(server, "/v1/chat/completions", {
        "model": "m", "max_tokens": 4, "temperature": 0.0, "tools": TOOLS,
        "messages": [
            {"role": "user", "content": "weather in Oslo?"},
            {"role": "assistant", "content": None, "tool_calls": [
                {"id": "call_abc", "type": "function",
                 "function": {"name": "get_weather", "arguments": "{\"city\": \"Oslo\"}"}}]},
            {"role": "tool", "tool_call_id": "call_abc", "content": "{\"temp\": -3}"}]})
    assert status == 200
    assert body["choices"][0]["message"]["content"]


def test_chat_tool_choice_invalid(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/v1/chat/completions", {
            "model": "m", "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
            "tool_choice": {"type": "function", "function": {"name": "nope"}}})
    assert e.value.code == 400


def test_oversized_prompt_rejected(server):
    """Past the KV cache's 1200 tokens: 429, not a request parked forever."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/v1/completions", {"model": "m", "prompt": "x" * 490, "max_tokens": 800,
                                          "temperature": 0.0})
    assert e.value.code == 429


# ------------------------------------------------------- the port's own


PROMPTS = ["hello world", "abcdef", "the quick brown fox", "q"]


def test_greedy_texts_equal_the_jax_llms(server):
    from scalellm_tpu import LLM, SamplingParams

    got = [_post(server, "/v1/completions", {"prompt": p, "max_tokens": 8, "temperature": 0.0,
                                             "ignore_eos": True})[1]["choices"][0]["text"] for p in PROMPTS]
    llm = LLM(tiny_llama(), block_size=4, num_blocks=300)
    try:
        want = [o.outputs[0].text for o in generate_within(
            llm, PROMPTS, SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))]
    finally:
        llm.close()
    assert got == want


def test_config_shows_the_options_and_the_model_args(server):
    import dataclasses

    from scalellm_tpu.model_loader.loader import HFModelLoader

    with urllib.request.urlopen(server + "/config", timeout=10) as r:
        cfg = json.loads(r.read())
    assert {k: cfg[k] for k in ("devices", "block_size", "num_blocks", "enable_cuda_graph", "warmup_mode",
                                "tp_size", "max_seqs_per_batch", "enable_async_scheduling")} == dict(
        devices="cpu", block_size=4, num_blocks=300, enable_cuda_graph=False, warmup_mode="full", tp_size=1,
        max_seqs_per_batch=128, enable_async_scheduling=True)
    want = dataclasses.asdict(HFModelLoader(tiny_llama()).model_args)
    want.pop("raw")
    assert cfg["model_args"] == json.loads(json.dumps(want))
    assert cfg["model_args_overrides_applied"] == []


def test_profile_writes_a_trace_of_the_steps(server, tmp_path):
    _, started = _post(server, "/profile/start", {"log_dir": str(tmp_path)})
    assert started == {"status": "tracing", "log_dir": str(tmp_path)}
    _post(server, "/v1/completions", {"prompt": "profile me", "max_tokens": 4, "temperature": 0.0})
    _, stopped = _post(server, "/profile/stop", {})
    assert stopped["status"] == "stopped"
    assert stopped["trace"].startswith(str(tmp_path))
    with open(stopped["trace"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # The scheduler loop's thread stepped the model: its matmuls are there.
    assert names & {"aten::mm", "aten::matmul", "aten::linear"}, sorted(n for n in names if n)[:20]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/profile/stop", {})
    assert e.value.code == 500


ASYNC_REFUSED = "enable_async_scheduling (set enable_async_scheduling=False)"


@pytest.mark.parametrize("flags,asked", [
    (("--tp-size", "2"), ASYNC_REFUSED),
    (("--tp-size", "2", "--sequence-parallel"), ASYNC_REFUSED),
    (("--coordinator", "127.0.0.1:1234", "--num-hosts", "2", "--host-id", "0"), ASYNC_REFUSED),
])
def test_parallel_flags_are_refused(flags, asked):
    """Parallel serving runs synchronously: with async scheduling left on
    (the default) the server refuses before it loads the model or joins a
    world (host 0 would otherwise wait for host 1 at the coordinator)."""
    proc = spawn(MODULE, "--model", tiny_llama(), "--port", str(free_port()), *FLAGS, *flags)
    try:
        code = proc.wait(timeout=120)
    finally:
        stop_all([proc])
    assert code != 0
    assert f"NotImplementedError: not ported with tp_size > 1 or distributed serving: {asked}" in output(proc)


def test_sigterm_stops_the_server():
    proc, base = _start()
    try:
        assert _post(base, "/v1/completions", {"prompt": "bye", "max_tokens": 2})[0] == 200
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=30)
    finally:
        stop_all([proc])
    assert code == 0
    assert time.monotonic() - t0 < 30
