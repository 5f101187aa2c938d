"""Tool calling in the port (utils/tools.py and the tool half of
utils/chat.py) against the JAX package, on the CPU: tests/test_tools.py case
for case, each run on both packages' functions with the same results, and a
forced tool call served through schedule_chat_async(tools=) on the tiny
Llama, whose text and parsed call equal scalellm_tpu's."""

import asyncio
import json
import re

import pytest

from tests.torch_port_util import tiny_llama

WEATHER = {
    "type": "function",
    "function": {
        "name": "get_weather",
        "description": "Get weather",
        "parameters": {
            "type": "object",
            "properties": {
                "city": {"type": "string"},
                "unit": {"type": "string", "enum": ["C", "F"]},
            },
            "required": ["city"],
        },
    },
}
TIME = {
    "type": "function",
    "function": {"name": "get_time", "parameters": {"type": "object"}},
}


def _both(module: str):
    """(port module, reference module) of scalellm_tpu*.<module>."""
    return (__import__(f"scalellm_tpu_torch.{module}", fromlist=["x"]),
            __import__(f"scalellm_tpu.{module}", fromlist=["x"]))


def _calls(calls):
    return [(c.name, json.loads(c.arguments)) for c in calls]


# ---------------------------------------------------------------- validation


def test_validate_tools():
    tools, ref = _both("utils.tools")
    assert tools.validate_tools([WEATHER, TIME]) == ref.validate_tools([WEATHER, TIME]) == [WEATHER, TIME]


@pytest.mark.parametrize("bad", [[], [{"type": "function"}], [{"type": "retrieval"}], "x"])
def test_validate_tools_refuses(bad):
    tools, ref = _both("utils.tools")
    for mod in (tools, ref):
        with pytest.raises(ValueError):
            mod.validate_tools(bad)


NAMED = {"type": "function", "function": {"name": "get_weather"}}


@pytest.mark.parametrize("choice, tools_given, want", [
    (None, [WEATHER], "auto"), ("none", None, "none"), ("required", [WEATHER], "required"),
    (NAMED, [WEATHER], NAMED)])
def test_validate_tool_choice(choice, tools_given, want):
    tools, ref = _both("utils.tools")
    assert tools.validate_tool_choice(choice, tools_given) == ref.validate_tool_choice(choice, tools_given) == want


@pytest.mark.parametrize("choice, tools_given", [
    ("required", None), ({"type": "function", "function": {"name": "nope"}}, [WEATHER]), ("banana", [WEATHER])])
def test_validate_tool_choice_refuses(choice, tools_given):
    tools, ref = _both("utils.tools")
    for mod in (tools, ref):
        with pytest.raises(ValueError):
            mod.validate_tool_choice(choice, tools_given)


# ------------------------------------------------------------------ parsing

PARSE_CASES = {
    "hermes": ('Sure!<tool_call>{"name": "get_weather", "arguments": {"city": "Oslo"}}</tool_call>',
               "Sure!", [("get_weather", {"city": "Oslo"})]),
    "hermes_multiple": ('<tool_call>{"name": "a", "arguments": {}}</tool_call>'
                        '<tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>',
                        None, [("a", {}), ("b", {"x": 1})]),
    "mistral": ('[TOOL_CALLS][{"name": "get_time", "arguments": {}}]', None, [("get_time", {})]),
    "bare_json": ('{"name": "get_weather", "arguments": {"city": "Paris", "unit": "C"}}', None,
                  [("get_weather", {"city": "Paris", "unit": "C"})]),
    "bare_json_parameters": ('{"name": "f", "parameters": {"a": 2}}', None, [("f", {"a": 2})]),
    "plain": ("just words", "just words", []),
    "not_a_call": ('{"not_a_call": 1}', '{"not_a_call": 1}', []),
    "garbage": ("<tool_call>garbage", "<tool_call>garbage", []),
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_parse_tool_calls(case):
    tools, ref = _both("utils.tools")
    text, content, calls = PARSE_CASES[case]
    got, want = tools.parse_tool_calls(text), ref.parse_tool_calls(text)
    assert got[0] == want[0] == content
    assert _calls(got[1]) == _calls(want[1]) == calls


OPENER_CASES = [("hello <tool_call>", None, 6), ('{"name": "x"', None, 0), ("plain", None, -1),
                ("words <tool", False, True), ("[TOOL_", False, True), ("words ", False, False),
                ('{"n', True, True), ('  [{"name"', True, True), ('{"n', False, False),
                ('{"other', True, False), ("{ ", True, True), ('{ "na', True, True), ('[ { "name"', True, True),
                ('{ "name" ', True, True), ('{ "nope', True, False)]


@pytest.mark.parametrize("text, at_start, want", OPENER_CASES)
def test_opener_detection(text, at_start, want):
    """tool_call_opener_pos where at_start is None, else might_open_tool_call
    (bare-JSON prefixes count only at the output's start, and tolerate the
    space the FSM's JSON grammar allows after a brace)."""
    tools, ref = _both("utils.tools")
    if at_start is None:
        got = (tools.tool_call_opener_pos(text), ref.tool_call_opener_pos(text))
    else:
        got = (tools.might_open_tool_call(text, at_start=at_start), ref.might_open_tool_call(text, at_start=at_start))
    assert got == (want, want)


def test_stream_tool_buffer_space_after_brace():
    tools, ref = _both("utils.tools")
    text = '{ "name": "lookup", "arguments": { "q": "x"}}'
    events = []
    for mod in (tools, ref):
        buf, evs = mod.StreamToolBuffer(), []
        for i, ch in enumerate(text):
            ev = buf.feed(ch, finished=(i == len(text) - 1))
            if ev is not None:
                evs.append(ev)
        assert len(evs) == 1 and evs[0][0] == "tool_calls" and evs[0][2][0].name == "lookup"
        events.append([(e[0], e[1], _calls(e[2])) for e in evs])
    assert events[0] == events[1]


# ----------------------------------------------------------- guided forcing

REGEX_CASES = [
    (None, '{"name": "get_weather", "arguments": {"city": "Oslo", "unit": "C"}}', True),
    (None, '{"name": "get_time", "arguments": {}}', True),
    (None, '{"name": "rm_rf", "arguments": {}}', False),
    (None, '{"name": "get_weather", "arguments": {"city": "Oslo", "unit": "K"}}', False),
    ("get_time", '{"name": "get_time", "arguments": {}}', True),
    ("get_time", '{"name": "get_weather", "arguments": {"city": "x"}}', False),
]


@pytest.mark.parametrize("name, text, matches", REGEX_CASES)
def test_guided_regex_for_tools(name, text, matches):
    tools, ref = _both("utils.tools")
    rx = tools.guided_regex_for_tools([WEATHER, TIME], name=name)
    assert rx == ref.guided_regex_for_tools([WEATHER, TIME], name=name)
    assert bool(re.compile(rx).fullmatch(text)) == matches


def test_guided_regex_named_tool_missing():
    tools, ref = _both("utils.tools")
    for mod in (tools, ref):
        with pytest.raises(ValueError):
            mod.guided_regex_for_tools([WEATHER], name="missing")


# ----------------------------------------------------------------- template


def _messages(chat):
    return [
        chat.Message("user", "weather?"),
        chat.Message("assistant", None, tool_calls=[{"id": "call_1", "type": "function",
                                                     "function": {"name": "get_weather", "arguments": "{}"}}]),
        chat.Message("tool", '{"temp": 5}', tool_call_id="call_1"),
    ]


def test_coded_template_gets_tools_block():
    chat, ref = _both("utils.chat")
    got = chat.apply_chat_template([chat.Message("user", "what's the weather?")], model_type="llama", tools=[WEATHER])
    want = ref.apply_chat_template([ref.Message("user", "what's the weather?")], model_type="llama", tools=[WEATHER])
    assert got == want
    assert "get_weather" in got and "what's the weather?" in got


def test_coded_template_flattens_tool_turns():
    chat, ref = _both("utils.chat")
    got = chat.apply_chat_template(_messages(chat), model_type="llama", tools=[WEATHER])
    assert got == ref.apply_chat_template(_messages(ref), model_type="llama", tools=[WEATHER])
    assert "get_weather" in got and '<tool_response>{"temp": 5}</tool_response>' in got


def test_jinja_template_receives_tools():
    chat, ref = _both("utils.chat")
    tmpl = ("{% if tools %}TOOLS:{% for t in tools %}{{ t.function.name }};{% endfor %}{% endif %}"
            "{% for m in messages %}[{{ m.role }}]{{ m.content }}{% endfor %}")
    got = chat.apply_chat_template([chat.Message("user", "hi")], jinja_template=tmpl, tools=[WEATHER, TIME])
    assert got == ref.apply_chat_template([ref.Message("user", "hi")], jinja_template=tmpl, tools=[WEATHER, TIME])
    assert got == "TOOLS:get_weather;get_time;[user]hi"


def test_message_roundtrip():
    chat, _ = _both("utils.chat")
    d = {"role": "assistant", "content": None,
         "tool_calls": [{"id": "x", "type": "function", "function": {"name": "f", "arguments": "{}"}}]}
    assert chat.Message.from_dict(d).to_dict() == d


# ------------------------------------------------------------- forced call


async def _forced_call(engine, msg_cls, sp_cls, tools_mod):
    sp = sp_cls(max_tokens=96, temperature=0.0, guided_regex=tools_mod.guided_regex_for_tools([WEATHER]))
    stream = await engine.schedule_chat_async([msg_cls("user", "weather in Oslo?")], sp, tools=[WEATHER])
    last = None
    async for out in stream:
        last = out
    return last


def _serve_forced(pkg: str, **kw):
    mod = __import__(pkg, fromlist=["x"])
    tools_mod = __import__(f"{pkg}.utils.tools", fromlist=["x"])
    engine = mod.AsyncLLMEngine(tiny_llama(), block_size=4, num_blocks=128, enable_cuda_graph=False,
                                num_handling_threads=1, **kw)
    engine.start()
    try:
        return asyncio.run(asyncio.wait_for(_forced_call(engine, mod.Message, mod.SamplingParams, tools_mod), 300))
    finally:
        engine.stop()


def test_forced_tool_call_through_schedule_chat_async_equals_the_jax_package():
    from scalellm_tpu.utils.tools import parse_tool_calls as ref_parse
    from scalellm_tpu_torch.utils.tools import parse_tool_calls

    got = _serve_forced("scalellm_tpu_torch", devices="cpu")
    want = _serve_forced("scalellm_tpu")
    assert got.status.ok and got.finished
    assert got.outputs[0].text == want.outputs[0].text
    content, calls = parse_tool_calls(got.outputs[0].text)
    ref_content, ref_calls = ref_parse(want.outputs[0].text)
    assert content == ref_content and _calls(calls) == _calls(ref_calls)
    if got.outputs[0].finish_reason.name == "STOP":  # a whole call: the tool's name, JSON arguments
        assert len(calls) == 1 and calls[0].name == "get_weather"
        assert isinstance(json.loads(calls[0].arguments)["city"], str)
