"""The port's REST-to-gRPC gateway (scalellm_tpu_torch/serve/gateway.py) in
front of the port's gRPC servers, subprocesses on the CPU:
tests/test_gateway.py's tests mirrored (models, completions plain and
streamed, chat, validation at the edge, tool calls, and two replicas behind
one gateway: routing, prefix affinity, failover); the routing rule itself
(BackendPool.pick) on fixed loads; and the JAX package's gateway in front
of the port's gRPC server (the wire names are the same), giving the port's
gateway's answers.

Both replicas are ready before the two-replica tests start (each answers
Models.List directly), and the routing test sends prompts whose affinity
falls on each replica, so it does not hang on timing as
tests/test_gateway.py::test_dp_routing_distributes can.
"""

import asyncio
import concurrent.futures
import json
import urllib.error
import urllib.request
import zlib

import grpc
import pytest

from scalellm_tpu_torch.serve.pb import llm_pb2
from tests.torch_port_util import free_port, http_ok, spawn, stop_all, tiny_llama, wait_ready

GRPC_FLAGS = ("--devices", "cpu", "--host", "127.0.0.1", "--num-blocks", "128", "--block-size", "4",
              "--disable-warmup")


def _post(url, body, timeout=180.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _post_sse(url, body, timeout=180.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            chunks.append(json.loads(payload))
    return chunks


def _replica():
    """A port gRPC server on a free port: (process, address)."""
    port = free_port()
    return spawn("scalellm_tpu_torch.serve.grpc_server", "--model", tiny_llama(), "--port", str(port),
                 *GRPC_FLAGS), f"127.0.0.1:{port}"


def _answers(addr):
    """Whether the server at `addr` answers Models.List."""
    with grpc.insecure_channel(addr) as ch:
        stub = ch.unary_unary("/scalellm_tpu.Models/List",
                              request_serializer=llm_pb2.ListModelsRequest.SerializeToString,
                              response_deserializer=llm_pb2.ListModelsResponse.FromString)
        return len(stub(llm_pb2.ListModelsRequest(), timeout=2).data) == 1


def _gateway(module, addrs):
    port = free_port()
    return spawn(module, "--grpc-server", ",".join(addrs), "--http-server", f"127.0.0.1:{port}"), \
        f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def backend():
    proc, addr = _replica()
    try:
        wait_ready([proc], lambda: _answers(addr), "grpc server")
        yield addr
    finally:
        stop_all([proc])


@pytest.fixture(scope="module")
def gateway(backend):
    proc, base = _gateway("scalellm_tpu_torch.serve.gateway", [backend])
    try:
        wait_ready([proc], lambda: http_ok(base + "/health"), "gateway")
        yield base
    finally:
        stop_all([proc])


COMPLETION = {"model": "m", "prompt": "hello", "max_tokens": 4, "temperature": 0.0, "ignore_eos": True}


def test_models_through_gateway(gateway):
    with urllib.request.urlopen(gateway + "/v1/models", timeout=30) as r:
        data = json.loads(r.read())
    assert data["object"] == "list"
    assert len(data["data"]) == 1


def test_completion_nonstream(gateway):
    resp = _post(gateway + "/v1/completions", COMPLETION)
    assert resp["object"] == "text_completion"
    assert resp["choices"][0]["finish_reason"] == "length"
    assert resp["usage"]["completion_tokens"] == 4


def test_completion_stream_sse(gateway):
    chunks = _post_sse(gateway + "/v1/completions", dict(COMPLETION, stream=True))
    assert chunks
    text = "".join(c["choices"][0]["text"] for c in chunks if c.get("choices"))
    assert len(text) > 0
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert text == _post(gateway + "/v1/completions", COMPLETION)["choices"][0]["text"]


def test_chat_through_gateway(gateway):
    resp = _post(gateway + "/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "temperature": 0.0,
        "ignore_eos": True})
    assert resp["object"] == "chat.completion"
    assert resp["choices"][0]["message"]["role"] == "assistant"


def test_validation_rejected_at_edge(gateway):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(gateway + "/v1/completions", {"model": "m", "prompt": "x", "max_tokens": 0})
    assert exc.value.code == 400


GW_TOOLS = [{"type": "function", "function": {
    "name": "lookup",
    "parameters": {"type": "object", "properties": {"q": {"type": "string", "maxLength": 8}}, "required": ["q"]}}}]


def test_tool_call_through_gateway(gateway):
    r = _post(gateway + "/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "call it"}], "max_tokens": 120,
        "temperature": 1.0, "tools": GW_TOOLS, "tool_choice": "required"})
    choice = r["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    call = choice["message"]["tool_calls"][0]
    assert call["function"]["name"] == "lookup"
    json.loads(call["function"]["arguments"])


def test_tool_call_streaming_through_gateway(gateway):
    chunks = _post_sse(gateway + "/v1/chat/completions", {
        "model": "m", "messages": [{"role": "user", "content": "call it"}], "max_tokens": 120,
        "temperature": 1.0, "stream": True, "tools": GW_TOOLS,
        "tool_choice": {"type": "function", "function": {"name": "lookup"}}})
    tool_deltas = [tc for c in chunks for tc in c["choices"][0]["delta"].get("tool_calls", [])]
    finishes = [c["choices"][0]["finish_reason"] for c in chunks if c["choices"][0]["finish_reason"]]
    assert finishes == ["tool_calls"], chunks
    assert tool_deltas[0]["function"]["name"] == "lookup"


def test_jax_gateway_in_front_of_the_ports_grpc_server(backend, gateway):
    """The JAX package's gateway speaks to the port's gRPC server: the same
    answers as the port's gateway, plain and streamed."""
    proc, base = _gateway("scalellm_tpu.serve.gateway", [backend])
    try:
        wait_ready([proc], lambda: http_ok(base + "/health"), "JAX gateway")
        got = _post(base + "/v1/completions", COMPLETION)
        streamed = _post_sse(base + "/v1/completions", dict(COMPLETION, stream=True))
        chat = _post(base + "/v1/chat/completions", {
            "model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "temperature": 0.0,
            "ignore_eos": True})
    finally:
        stop_all([proc])
    want = _post(gateway + "/v1/completions", COMPLETION)
    assert (got["choices"], got["usage"]) == (want["choices"], want["usage"])
    assert "".join(c["choices"][0]["text"] for c in streamed) == want["choices"][0]["text"]
    assert chat["choices"][0]["message"]["role"] == "assistant" and chat["usage"]["completion_tokens"] == 4


# ------------------------------------------------------- two replicas


@pytest.fixture(scope="module")
def dp_gateway():
    (p1, a1), (p2, a2) = _replica(), _replica()
    procs = [p1, p2]
    try:
        for addr in (a1, a2):
            wait_ready(procs, lambda: _answers(addr), f"replica {addr}")
        gw, base = _gateway("scalellm_tpu_torch.serve.gateway", [a1, a2])
        procs.append(gw)
        wait_ready(procs, lambda: http_ok(base + "/health"), "gateway")
        yield base, [p1, p2], [a1, a2]
    finally:
        stop_all(procs)


def _stats(base):
    with urllib.request.urlopen(base + "/gateway/replicas", timeout=10) as r:
        return {s["addr"]: s for s in json.loads(r.read())["replicas"]}


def _affine(n_replicas, index, count, stem):
    """`count` prompts whose affinity key (the prompt) hashes to replica
    `index` (BackendPool.pick's crc32 rule)."""
    out, i = [], 0
    while len(out) < count:
        p = f"{stem} {i}"
        if zlib.crc32(p.encode()) % n_replicas == index:
            out.append(p)
        i += 1
    return out


def test_dp_routing_distributes(dp_gateway):
    base, _, addrs = dp_gateway
    before = _stats(base)
    prompts = _affine(2, 0, 6, "dp req") + _affine(2, 1, 6, "dp req")

    def one(p):
        return _post(base + "/v1/completions", {"model": "m", "prompt": p, "max_tokens": 2, "temperature": 0.0,
                                                "ignore_eos": True}, timeout=120)

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(one, prompts))
    assert all(r["choices"][0]["text"] for r in results)
    after = _stats(base)
    served = [after[a]["served"] - before[a]["served"] for a in addrs]
    assert sum(served) == 12 and all(s > 0 for s in served), served
    assert all(after[a]["failures"] == 0 and after[a]["inflight"] == 0 for a in addrs), after


def test_affinity_routing_prefers_same_replica(dp_gateway):
    base, _, _ = dp_gateway
    before = _stats(base)
    for _ in range(4):
        _post(base + "/v1/completions", {"model": "m", "prompt": "affinity shared prefix prompt", "max_tokens": 2,
                                         "temperature": 0.0, "ignore_eos": True}, timeout=120)
    after = _stats(base)
    deltas = sorted(after[a]["served"] - before[a]["served"] for a in after)
    assert deltas == [0, 4], deltas


def test_dp_failover(dp_gateway):
    base, replicas, addrs = dp_gateway
    stop_all(replicas[:1])
    ok = 0
    for p in _affine(2, 0, 4, "failover"):  # each prefers the stopped replica
        try:
            r = _post(base + "/v1/completions", {"model": "m", "prompt": p, "max_tokens": 2, "temperature": 0.0,
                                                 "ignore_eos": True}, timeout=120)
            ok += bool(r["choices"][0]["text"])
        except urllib.error.HTTPError:
            pass  # a hit before the breaker trips may fail
    assert ok >= 3
    assert _stats(base)[addrs[0]]["failures"] >= 1
    assert http_ok(base + "/health")


def test_backend_pool_picks_the_least_loaded_replica():
    """BackendPool.pick on fixed loads: the least-loaded healthy replica;
    the prompt's affinity replica while its backlog is within
    AFFINITY_SLACK of the least, else the least; a replica marked down is
    skipped until its cooldown ends, unless every replica is down."""
    from scalellm_tpu_torch.serve.gateway import BackendPool

    async def run():
        pool = BackendPool(["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"])
        a, b, c = pool.replicas
        try:
            a.inflight, b.inflight, c.inflight = 3, 1, 2
            picks = {pool.pick().addr for _ in range(6)}
            key = next(p for p in _affine(3, 0, 1, "k"))  # prefers a
            preferred = pool.pick(affinity_key=key)
            a.inflight = 1 + pool.AFFINITY_SLACK + 1
            overloaded = pool.pick(affinity_key=key)
            a.inflight = b.inflight = c.inflight = 0
            pool.mark_down(b)
            while_down = {pool.pick().addr for _ in range(6)}
            excluded = pool.pick(exclude=a)
            for r in pool.replicas:
                pool.mark_down(r)
            all_down = {pool.pick().addr for _ in range(6)}
            return picks, preferred, overloaded, while_down, excluded, all_down
        finally:
            await pool.close()

    picks, preferred, overloaded, while_down, excluded, all_down = asyncio.run(run())
    assert picks == {"127.0.0.1:2"}
    assert preferred.addr == "127.0.0.1:1" and overloaded.addr == "127.0.0.1:2"
    assert while_down == {"127.0.0.1:1", "127.0.0.1:3"}
    assert excluded.addr == "127.0.0.1:3"
    assert all_down == {"127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"}
