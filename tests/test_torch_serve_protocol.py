"""The port's OpenAI protocol (serve/api_protocol.py) and its completion and
chat handlers against the JAX package's, on the CPU with no engine:

- a table of request bodies, valid and invalid, parsed by both packages:
  the same request fields, SamplingParams, priority and SamplingParams
  verification, or the same ValidationError code and message;
- both packages' handlers fed the same scripted RequestOutputs by a fake
  engine: equal JSON bodies and SSE chunk sequences, apart from the
  response ids, the creation times and the tool calls' ids;
- the port's stream sends a finish reason once, in its last item, when the
  response thread runs behind the scheduler.
"""

import asyncio
import dataclasses
import json

import pytest

from tests.torch_port_util import tiny_llama

def _mod(pkg, name):
    return __import__(f"{pkg}.{name}", fromlist=["x"])


TOOL = {"type": "function", "function": {
    "name": "get_weather", "description": "Get weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string", "maxLength": 12}},
                   "required": ["city"]}}}
SCHEMA = {"type": "object", "properties": {"n": {"type": "integer"}}, "required": ["n"]}
USER = [{"role": "user", "content": "hi"}]

COMPLETION_BODIES = {
    "minimal": {"prompt": "hi"},
    "everything": {"model": "m", "prompt": ["a", "b"], "max_tokens": 5, "n": 2, "best_of": 3, "stop": "x",
                   "echo": True, "logprobs": 2, "seed": 7, "priority": "high", "top_k": 5, "top_p": 0.5,
                   "temperature": 0, "frequency_penalty": 0.5, "presence_penalty": 0.25,
                   "repetition_penalty": 1.1, "stop_token_ids": [1, 2], "user": "u", "skip_special_tokens": False,
                   "ignore_eos": True},
    "stop_list": {"prompt": "hi", "stop": ["a", "bc"], "priority": "low"},
    "logit_bias": {"prompt": "hi", "logit_bias": {"5": 2.5, "7": -1}},
    "logit_bias_key": {"prompt": "hi", "logit_bias": {"x": 1}},
    "logit_bias_value": {"prompt": "hi", "logit_bias": {"5": "a"}},
    "logit_bias_bool": {"prompt": "hi", "logit_bias": {"5": True}},
    "logit_bias_list": {"prompt": "hi", "logit_bias": [1]},
    "logit_bias_range": {"prompt": "hi", "logit_bias": {"5": 101}},
    "prompt_int": {"prompt": 5},
    "prompt_ints": {"prompt": [1, 2]},
    "max_tokens_str": {"prompt": "hi", "max_tokens": "3"},
    "max_tokens_0": {"prompt": "x", "max_tokens": 0},
    "temperature_negative": {"prompt": "x", "temperature": -1},
    "n_above_best_of": {"prompt": "x", "n": 3, "best_of": 2},
    "guided_regex": {"prompt": "hi", "guided_regex": "[0-9]+"},
    "guided_regex_int": {"prompt": "hi", "guided_regex": 5},
    "guided_json": {"prompt": "hi", "guided_json": SCHEMA},
    "guided_json_str": {"prompt": "hi", "guided_json": json.dumps(SCHEMA)},
    "guided_json_int": {"prompt": "hi", "guided_json": 5},
    "guided_choice": {"prompt": "hi", "guided_choice": ["a", "b"]},
    "guided_choice_str": {"prompt": "hi", "guided_choice": "a"},
    "guided_choice_ints": {"prompt": "hi", "guided_choice": [1]},
    "guided_two": {"prompt": "hi", "guided_regex": "a", "guided_choice": ["a"]},
    "json_object": {"prompt": "hi", "response_format": {"type": "json_object"}},
    "json_schema": {"prompt": "hi", "response_format": {"type": "json_schema", "json_schema": {"schema": SCHEMA}}},
    "json_schema_missing": {"prompt": "hi", "response_format": {"type": "json_schema"}},
    "response_text": {"prompt": "hi", "response_format": {"type": "text"}},
    "response_xml": {"prompt": "hi", "response_format": {"type": "xml"}},
    "response_untyped": {"prompt": "hi", "response_format": {}},
    "echo_logprobs": {"prompt": "hi", "echo": True, "logprobs": 3},
    "logprobs_many": {"prompt": "hi", "logprobs": 21},
    "not_an_object": ["prompt"],
    "priority_int": {"prompt": "hi", "priority": 1},
}

CHAT_BODIES = {
    "minimal": {"messages": USER},
    "everything": {"model": "m", "messages": USER, "max_tokens": 5, "n": 2, "stop": "x", "seed": 3,
                   "logprobs": True, "top_logprobs": 3, "priority": "low", "temperature": 0.2, "top_k": 4,
                   "ignore_eos": True, "stop_token_ids": [3]},
    "no_messages": {"model": "m"},
    "empty_messages": {"messages": []},
    "no_role": {"messages": [{"content": "hi"}]},
    "null_content": {"messages": [{"role": "user", "content": None}]},
    "tool_turns": {"messages": [
        {"role": "user", "content": "weather?"},
        {"role": "assistant", "content": None, "tool_calls": [
            {"id": "c1", "type": "function", "function": {"name": "get_weather", "arguments": "{}"}}]},
        {"role": "tool", "tool_call_id": "c1", "content": "sunny"}], "tools": [TOOL]},
    "tools_auto": {"messages": USER, "tools": [TOOL]},
    "tools_required": {"messages": USER, "tools": [TOOL], "tool_choice": "required"},
    "tools_named": {"messages": USER, "tools": [TOOL],
                    "tool_choice": {"type": "function", "function": {"name": "get_weather"}}},
    "tools_unknown": {"messages": USER, "tools": [TOOL],
                      "tool_choice": {"type": "function", "function": {"name": "nope"}}},
    "tools_none": {"messages": USER, "tools": [TOOL], "tool_choice": "none"},
    "tools_not_list": {"messages": USER, "tools": TOOL},
    "tools_no_name": {"messages": USER, "tools": [{"type": "function", "function": {}}]},
    "choice_without_tools": {"messages": USER, "tool_choice": "required"},
    "forced_and_guided": {"messages": USER, "tools": [TOOL], "tool_choice": "required", "guided_regex": "a"},
    "guided_choice": {"messages": USER, "guided_choice": ["yes", "no"]},
    "json_object": {"messages": USER, "response_format": {"type": "json_object"}},
    "logit_bias": {"messages": USER, "logit_bias": {"9": -100}},
    "top_logprobs_str": {"messages": USER, "top_logprobs": "2"},
    "max_tokens_0": {"messages": USER, "max_tokens": 0},
}


def _parse(pkg, kind, body):
    """What the server does with a body, in package `pkg`: the request's
    fields, its SamplingParams, priority and verification; or the first
    ValidationError's (code, message)."""
    proto = _mod(pkg, "serve.api_protocol")
    errors = _mod(pkg, "errors")
    cls = proto.CompletionRequest if kind == "completion" else proto.ChatCompletionRequest
    try:
        req = cls.from_json(body)
        sp = req.to_sampling_params()
        sp.verify()
        return dict(request=dataclasses.asdict(req), sampling=dataclasses.asdict(sp),
                    priority=req.to_priority().name)
    except errors.ValidationError as e:
        return (e.code.name, e.message)


@pytest.mark.parametrize("kind,name", [("completion", n) for n in COMPLETION_BODIES]
                         + [("chat", n) for n in CHAT_BODIES])
def test_request_bodies_parse_as_the_references(kind, name):
    body = (COMPLETION_BODIES if kind == "completion" else CHAT_BODIES)[name]
    got, want = (_parse(pkg, kind, body) for pkg in ("scalellm_tpu_torch", "scalellm_tpu"))
    assert got == want
    # The table has both: bodies that parse, and each kind of refusal.
    if name in ("minimal", "everything", "logit_bias", "tools_required", "json_schema"):
        assert isinstance(got, dict)
    if name.startswith(("logit_bias_", "prompt_", "guided_choice_", "no_", "tools_unknown", "forced")):
        assert got[0] == "INVALID_ARGUMENT"


def test_status_codes_map_to_the_references_http_statuses():
    got, want = (_mod(pkg, "serve.api_protocol") for pkg in ("scalellm_tpu_torch", "scalellm_tpu"))
    for code in _mod("scalellm_tpu_torch", "request.output").StatusCode:
        assert got.status_to_http(code) == want.status_to_http(_mod("scalellm_tpu", "request.output").StatusCode[code.name])
    assert got.error_json("m", code=404) == want.error_json("m", code=404)


# ------------------------------------------------------------ the handlers


def _outputs(pkg, script):
    """A script's RequestOutputs in package `pkg`'s types. A script item is
    (finished, [(index, text, finish or None, logprobs or None)], usage or
    None, prompt_logprobs or None); a logprob is (token, id, logprob,
    [(token, id, logprob)])."""
    out = _mod(pkg, "request.output")

    def lp(e):
        if e is None:
            return None
        token, tid, value, top = e
        return out.LogProb(token=token, token_id=tid, logprob=value,
                           top_logprobs=[out.LogProbData(token=t, token_id=i, logprob=v) for t, i, v in top])

    items = []
    for finished, seqs, usage, prompt_lps in script:
        items.append(out.RequestOutput(
            status=out.Status(out.StatusCode.OK), finished=finished,
            outputs=[out.SequenceOutput(index=i, text=t, finish_reason=None if f is None else out.FinishReason[f],
                                        logprobs=None if lps is None else [lp(e) for e in lps])
                     for i, t, f, lps in seqs],
            usage=None if usage is None else out.Usage(*usage),
            prompt_logprobs=None if prompt_lps is None else [lp(e) for e in prompt_lps]))
    return items


class FakeEngine:
    """schedule_async / schedule_chat_async of AsyncLLMEngine, answering
    every request with its script's outputs (all items when streamed, the
    last one otherwise, as the engine's output streams do)."""

    def __init__(self, pkg, scripts):
        self.pkg, self.scripts, self.calls = pkg, list(scripts), []

    async def _stream(self, items):
        for item in items:
            yield item

    async def schedule_async(self, prompt, sp, priority=None, stream=False, lora=None):
        self.calls.append((prompt, priority.name, stream, lora))
        items = _outputs(self.pkg, self.scripts.pop(0))
        return self._stream(items if stream else items[-1:])

    async def schedule_chat_async(self, messages, sp, priority=None, stream=False, tools=None, lora=None):
        self.calls.append(([m.role for m in messages], priority.name, stream, tools, lora, sp.guided_regex))
        items = _outputs(self.pkg, self.scripts.pop(0))
        return self._stream(items if stream else items[-1:])


LP = ("a", 97, -0.5, [("a", 97, -0.5), ("b", 98, -1.5)])
TEXT_SCRIPT = [(False, [(0, "Hel", None, [LP])], None, None),
               (False, [(0, "lo", None, [LP])], None, None),
               (True, [(0, "", "LENGTH", None)], (3, 2), [None, LP, LP])]
FINAL_SCRIPT = [(True, [(0, "Hello", "LENGTH", [LP, LP])], (3, 2), [None, LP, LP])]
TWO_SEQS = [(True, [(0, "ab", "STOP", None), (1, "cd", "LENGTH", None)], (2, 4), None)]
CALL = '<tool_call>{"name": "get_weather", "arguments": {"city": "Oslo"}}</tool_call>'
TOOL_STREAM = [(False, [(0, CALL[:9], None, None)], None, None),
               (False, [(0, CALL[9:40], None, None)], None, None),
               (False, [(0, CALL[40:], None, None)], None, None),
               (True, [(0, "", "STOP", None)], (5, 20), None)]
TOOL_FINAL = [(True, [(0, "Sure. " + CALL, "STOP", None)], (5, 22), None)]

HANDLER_CASES = {
    # name: (kind, body, scripts, lora names of the server)
    "completion": ("completion", {"prompt": "abc", "max_tokens": 2}, [FINAL_SCRIPT], ()),
    "completion_logprobs_echo": ("completion", {"prompt": "abc", "echo": True, "logprobs": 2}, [FINAL_SCRIPT], ()),
    "completion_logprobs": ("completion", {"prompt": "abc", "logprobs": 2}, [FINAL_SCRIPT], ()),
    "completion_list": ("completion", {"prompt": ["abc", "de"], "priority": "high"},
                        [FINAL_SCRIPT, TWO_SEQS], ()),
    "completion_lora": ("completion", {"model": "one", "prompt": "abc"}, [FINAL_SCRIPT], ("one",)),
    "completion_stream": ("completion", {"prompt": "abc", "stream": True, "logprobs": 1}, [TEXT_SCRIPT], ()),
    "completion_stream_list": ("completion", {"prompt": ["abc", "x"], "stream": True}, [TEXT_SCRIPT], ()),
    "chat": ("chat", {"messages": USER}, [FINAL_SCRIPT], ()),
    "chat_logprobs": ("chat", {"messages": USER, "logprobs": True, "top_logprobs": 2}, [FINAL_SCRIPT], ()),
    "chat_two": ("chat", {"messages": USER, "n": 2}, [TWO_SEQS], ()),
    "chat_stream": ("chat", {"messages": USER, "stream": True}, [TEXT_SCRIPT], ()),
    "chat_tool_call": ("chat", {"messages": USER, "tools": [TOOL]}, [TOOL_FINAL], ()),
    "chat_tool_forced": ("chat", {"messages": USER, "tools": [TOOL], "tool_choice": "required"}, [TOOL_FINAL], ()),
    "chat_tool_none": ("chat", {"messages": USER, "tools": [TOOL], "tool_choice": "none"}, [TOOL_FINAL], ()),
    "chat_tool_stream": ("chat", {"messages": USER, "tools": [TOOL], "stream": True}, [TOOL_STREAM], ()),
    "chat_tool_stream_text": ("chat", {"messages": USER, "tools": [TOOL], "stream": True}, [TEXT_SCRIPT], ()),
    "chat_lora_stream": ("chat", {"model": "one", "messages": USER, "stream": True}, [TEXT_SCRIPT], ("one",)),
}


def _scrub(obj):
    """A response without what differs from call to call: ids, times."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_scrub(v) for v in obj)
    return obj


def _handle(pkg, kind, body, scripts, loras):
    """(response JSON or SSE chunks, the fake engine's calls) of package
    `pkg`'s handler for one request, as its ApiServer routes it."""
    proto = _mod(pkg, "serve.api_protocol")
    http = _mod(pkg, "serve.http")
    if kind == "completion":
        h = _mod(pkg, "serve.completion_handler")
        req = proto.CompletionRequest.from_json(body)
        plain, streamed = h.generate_completion_response, h.generate_completion_stream
    else:
        h = _mod(pkg, "serve.chat_handler")
        req = proto.ChatCompletionRequest.from_json(body)
        plain, streamed = h.generate_chat_response, h.generate_chat_stream
    engine = FakeEngine(pkg, scripts)
    lora = req.model if req.model in loras else None

    async def run():
        if not req.stream:
            resp = await plain(engine, req, "m", lora=lora)
            return resp.status, json.loads(resp.body)
        sse = http.SSEResponse()
        await streamed(engine, req, "m", sse, lora=lora)
        chunks = []
        while True:
            item = sse._queue.get_nowait()
            if item is None:
                return chunks
            chunks.append(item.decode())

    got = asyncio.run(asyncio.wait_for(run(), 30))
    if req.stream:
        got = [c if c == "data: [DONE]\n\n" else json.loads(c[len("data: "):]) for c in got]
    return _scrub(got), engine.calls


@pytest.mark.parametrize("name", list(HANDLER_CASES))
def test_handlers_answer_as_the_references(name):
    kind, body, scripts, loras = HANDLER_CASES[name]
    got, want = (_handle(pkg, kind, body, scripts, loras) for pkg in ("scalellm_tpu_torch", "scalellm_tpu"))
    assert got == want
    out = got[0]
    if name in ("chat_tool_call", "chat_tool_forced"):
        choice = out[1]["choices"][0]
        assert choice["finish_reason"] == "tool_calls"
        assert json.loads(choice["message"]["tool_calls"][0]["function"]["arguments"]) == {"city": "Oslo"}
    if name == "chat_tool_stream":
        assert [c["choices"][0]["finish_reason"] for c in out[:-1]] == ["tool_calls"]
    if name == "completion_list":
        assert [c["index"] for c in out[1]["choices"]] == [0, 1, 2]
    if name.endswith("stream"):
        assert out[-1] == "data: [DONE]\n\n"


def test_a_stream_sends_its_finish_reason_once():
    """The response thread held back behind the scheduler, so that each
    stream job runs after the request's last token: the port's stream still
    carries its finish reason once, in its last item, and its deltas make
    the final text."""
    import time

    from scalellm_tpu_torch import AsyncLLMEngine, SamplingParams
    from scalellm_tpu_torch.scheduler.response_handler import ResponseHandler

    engine = AsyncLLMEngine(tiny_llama(), devices="cpu", block_size=4, num_blocks=64, enable_cuda_graph=False)
    real = ResponseHandler._do_stream

    def late(self, request):
        time.sleep(0.05)
        real(self, request)

    engine._handler._response_handler._do_stream = late.__get__(engine._handler._response_handler)
    engine.start()
    try:
        sp = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)

        async def go():
            streamed = [o async for o in await engine.schedule_async("finish once", sp, stream=True)]
            final = [o async for o in await engine.schedule_async("finish once", sp)]
            return streamed, final[-1]

        streamed, final = asyncio.run(asyncio.wait_for(go(), 120))
    finally:
        engine.stop()
    reasons = [so.finish_reason for o in streamed for so in o.outputs]
    assert [r is not None for r in reasons] == [False] * (len(reasons) - 1) + [True]
    assert "".join(so.text for o in streamed for so in o.outputs) == final.outputs[0].text
    assert streamed[-1].finished and streamed[-1].usage.num_generated_tokens == 6
