"""The port's gRPC server (scalellm_tpu_torch/serve/grpc_server.py) as a
subprocess on the CPU (`--devices cpu`): tests/test_grpc_server.py's 4
tests mirrored against it (Completion.Complete streamed, Chat.Complete,
Models.List, an invalid request aborted with INVALID_ARGUMENT), and its
greedy completion equal to the JAX package's gRPC server's over the same
wire names."""

import grpc
import pytest

from scalellm_tpu_torch.serve.pb import llm_pb2
from tests.torch_port_util import free_port, spawn, stop_all, tiny_llama, wait_ready

FLAGS = ("--host", "127.0.0.1", "--num-blocks", "128", "--block-size", "4", "--disable-warmup")


def start_grpc(module, *extra):
    """A gRPC server of `module` on a free port, and a channel to it."""
    port = free_port()
    proc = spawn(module, "--model", tiny_llama(), "--port", str(port), *FLAGS, *extra)
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        wait_ready([proc], lambda: grpc.channel_ready_future(channel).result(timeout=2) is None, "grpc server")
    except BaseException:
        channel.close()
        stop_all([proc])
        raise
    return proc, channel


@pytest.fixture(scope="module")
def grpc_server():
    proc, channel = start_grpc("scalellm_tpu_torch.serve.grpc_server", "--devices", "cpu")
    try:
        yield channel
    finally:
        channel.close()
        stop_all([proc])


def _complete(channel):
    return channel.unary_stream(
        "/scalellm_tpu.Completion/Complete",
        request_serializer=llm_pb2.CompletionRequest.SerializeToString,
        response_deserializer=llm_pb2.CompletionResponse.FromString,
    )


def test_models_list(grpc_server):
    stub = grpc_server.unary_unary(
        "/scalellm_tpu.Models/List",
        request_serializer=llm_pb2.ListModelsRequest.SerializeToString,
        response_deserializer=llm_pb2.ListModelsResponse.FromString,
    )
    resp = stub(llm_pb2.ListModelsRequest(), timeout=30)
    assert resp.object == "list"
    assert len(resp.data) == 1


def test_completion_stream(grpc_server):
    req = llm_pb2.CompletionRequest(
        model="m", prompt="hello", stream=True,
        sampling=llm_pb2.SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True),
    )
    chunks = list(_complete(grpc_server)(req, timeout=180))
    assert chunks
    text = "".join(c.choices[0].text for c in chunks if c.choices)
    assert len(text) > 0
    assert chunks[-1].choices[0].finish_reason == "length"
    assert [c.choices[0].HasField("finish_reason") for c in chunks if c.choices][:-1] == [False] * (len(chunks) - 1)


def test_chat_nonstream(grpc_server):
    stub = grpc_server.unary_stream(
        "/scalellm_tpu.Chat/Complete",
        request_serializer=llm_pb2.ChatRequest.SerializeToString,
        response_deserializer=llm_pb2.ChatResponse.FromString,
    )
    req = llm_pb2.ChatRequest(
        model="m", messages=[llm_pb2.ChatMessage(role="user", content="hi")],
        sampling=llm_pb2.SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True),
    )
    resps = list(stub(req, timeout=180))
    assert len(resps) == 1
    assert resps[0].object == "chat.completion"
    assert resps[0].choices[0].message.role == "assistant"
    assert resps[0].usage.completion_tokens == 4


def test_invalid_params_abort(grpc_server):
    req = llm_pb2.CompletionRequest(model="m", prompt="x", sampling=llm_pb2.SamplingParams(max_tokens=0))
    with pytest.raises(grpc.RpcError) as exc:
        list(_complete(grpc_server)(req, timeout=60))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_greedy_completion_equals_the_jax_grpc_servers(grpc_server):
    """The same request to both packages' servers: the same text and usage
    (the JAX package's server holds the reference's messages)."""
    req = llm_pb2.CompletionRequest(
        model="m", prompt="the quick brown fox",
        sampling=llm_pb2.SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True),
    )
    got = list(_complete(grpc_server)(req, timeout=180))[-1]
    proc, channel = start_grpc("scalellm_tpu.serve.grpc_server")
    try:
        want = list(_complete(channel)(req, timeout=180))[-1]
    finally:
        channel.close()
        stop_all([proc])
    assert (got.choices[0].text, got.choices[0].finish_reason, got.usage) == (
        want.choices[0].text, want.choices[0].finish_reason, want.usage)
