"""OpenAI-compatible function/tool calling for chat completions.

A copy of scalellm_tpu/utils/tools.py. Three pieces:

  - request-side: validate ``tools`` / ``tool_choice``, render tool
    definitions into the prompt (jinja templates that accept ``tools=``
    get them natively; coded-template fallbacks get a generated system
    block), and — when ``tool_choice`` forces a call — build the guided
    constraint (constrained/) so the model MUST emit a parseable call.
  - output-side: parse generated text into ``tool_calls`` entries. The
    parser recognizes the three formats in the wild: hermes/qwen
    ``<tool_call>{...}</tool_call>``, mistral ``[TOOL_CALLS][...]``, and
    bare-JSON ``{"name": ..., "arguments"|"parameters": ...}`` (llama3).
  - streaming: the chat handler holds back text once a tool-call opener
    is detected and emits the parsed calls as a final delta.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class ToolCall:
    name: str
    arguments: str  # JSON-encoded argument object (OpenAI wire format)
    id: str = ""

    def to_json(self) -> Dict[str, Any]:
        return {
            "id": self.id or f"call_{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }


def validate_tools(tools: Any) -> List[Dict[str, Any]]:
    """Validate an OpenAI `tools` array; returns it normalized."""
    if not isinstance(tools, list) or not tools:
        raise ValueError("tools must be a non-empty list")
    out = []
    for t in tools:
        if not isinstance(t, dict) or t.get("type") != "function":
            raise ValueError("each tool must be {'type': 'function', ...}")
        fn = t.get("function")
        if not isinstance(fn, dict) or not isinstance(fn.get("name"), str):
            raise ValueError("tool.function must have a string 'name'")
        params = fn.get("parameters")
        if params is not None and not isinstance(params, dict):
            raise ValueError("tool.function.parameters must be an object")
        out.append(t)
    return out


def validate_tool_choice(tc: Any, tools: Optional[List[Dict]]) -> Any:
    if tc is None:
        return "auto"
    if tc in ("auto", "none", "required"):
        if tc != "none" and not tools:
            raise ValueError(f"tool_choice {tc!r} requires tools")
        return tc
    if isinstance(tc, dict) and tc.get("type") == "function":
        name = (tc.get("function") or {}).get("name")
        if not isinstance(name, str) or not name:
            raise ValueError("tool_choice.function.name must be a string")
        if not tools or name not in [t["function"]["name"] for t in tools]:
            raise ValueError(f"tool_choice names unknown tool {name!r}")
        return tc
    raise ValueError(
        "tool_choice must be 'auto' | 'none' | 'required' | "
        "{'type': 'function', 'function': {'name': ...}}"
    )


# ------------------------------------------------------------ prompt side


SYSTEM_TOOLS_TEMPLATE = """You have access to the following functions. \
To call a function, respond ONLY with a JSON object \
{{"name": <function-name>, "arguments": <args-json-object>}}.

{tool_defs}"""


def render_tools_block(tools: Sequence[Dict[str, Any]]) -> str:
    """Fallback system-prompt block for coded (non-jinja) templates."""
    defs = "\n".join(
        json.dumps(t["function"], ensure_ascii=False) for t in tools
    )
    return SYSTEM_TOOLS_TEMPLATE.format(tool_defs=defs)


def guided_regex_for_tools(
    tools: Sequence[Dict[str, Any]], name: Optional[str] = None
) -> str:
    """Regex forcing `{"name": "<fn>", "arguments": {...schema...}}`.

    Used when tool_choice is 'required' (union over all tools) or names a
    specific function. The constrained decoder guarantees the output
    parses; parse_tool_calls' bare-JSON branch picks it up.
    """
    from scalellm_tpu_torch.constrained.json_schema import schema_regex

    alts = []
    for t in tools:
        fn = t["function"]
        if name is not None and fn["name"] != name:
            continue
        params = fn.get("parameters") or {"type": "object"}
        alts.append(
            schema_regex(
                {
                    "type": "object",
                    "properties": {
                        "name": {"const": fn["name"]},
                        "arguments": params,
                    },
                    "required": ["name", "arguments"],
                }
            )
        )
    if not alts:
        raise ValueError(f"tool {name!r} not found in tools")
    return "|".join(f"(?:{a})" for a in alts)


# ------------------------------------------------------------ output side

# Openers that mark "the rest of this output is a tool call".
_HERMES_OPEN = "<tool_call>"
_HERMES_CLOSE = "</tool_call>"
_MISTRAL_OPEN = "[TOOL_CALLS]"

# Bare-JSON detection: output (after whitespace) starts with {"name": or
# [{"name": — llama3-style and what guided forcing produces.
_BARE_RE = re.compile(r'^\s*\[?\s*\{\s*"name"\s*:')


def tool_call_opener_pos(text: str) -> int:
    """Index where a tool-call section starts, or -1.

    Streaming uses this to hold back text: everything before the opener
    streams as content, the rest buffers until finish.
    """
    best = -1
    for marker in (_HERMES_OPEN, _MISTRAL_OPEN):
        i = text.find(marker)
        if i != -1 and (best == -1 or i < best):
            best = i
    if best == -1 and _BARE_RE.match(text):
        best = 0
    return best


_BARE_TARGET = '{"name"'


def _bare_prefix(text: str) -> bool:
    """Could `text` (from output start) grow into a bare-JSON tool call?
    Mirrors _BARE_RE's tolerance: whitespace around the brackets/brace and
    before the colon."""
    t = text.lstrip()
    if t.startswith("["):
        t = t[1:].lstrip()
    if t.startswith("{"):
        t = "{" + t[1:].lstrip()
    if len(t) <= len(_BARE_TARGET):
        return _BARE_TARGET.startswith(t)
    if t.startswith(_BARE_TARGET):
        # between the key and the colon only whitespace may appear
        return t[len(_BARE_TARGET):].strip() in ("", ":")
    return False


def might_open_tool_call(tail: str, at_start: bool = False) -> bool:
    """True if `tail` could be a prefix of an opener (hold back streaming).

    `at_start`: no content emitted yet — also consider the bare-JSON form
    (which is only recognized anchored at the start of the output).
    """
    for marker in (_HERMES_OPEN, _MISTRAL_OPEN):
        for k in range(1, min(len(marker), len(tail)) + 1):
            if tail.endswith(marker[:k]):
                return True
    return at_start and _bare_prefix(tail)


class StreamToolBuffer:
    """Streaming hold-back state machine for one output index: feed text
    deltas, get back ('content', text) / ('tool_calls', content, calls) /
    None (buffering). Used by the gRPC chat stream; the SSE handler
    implements the same protocol inline."""

    def __init__(self):
        self._buf = ""
        self._emitted = False

    def feed(self, text: str, finished: bool):
        buf = self._buf + text
        opener = tool_call_opener_pos(buf)
        if opener == 0 and self._emitted and not buf.lstrip().startswith(("<", "[T")):
            opener = -1  # bare-JSON form only counts at output start
        pre = None
        if opener > 0:
            pre = buf[:opener]
            self._emitted = True
            buf = buf[opener:]
            opener = 0
        if opener == 0:
            self._buf = buf
            if not finished:
                return ("content", pre) if pre else None
            content, calls = parse_tool_calls(buf)
            self._buf = ""
            if calls:
                if pre:
                    content = pre + (content or "")
                return ("tool_calls", content, calls)
            return ("content", (pre or "") + buf)
        if might_open_tool_call(buf, at_start=not self._emitted) and not finished:
            self._buf = buf
            return None
        self._buf = ""
        self._emitted = True
        return ("content", buf)


def _normalize_call(obj: Any) -> Optional[ToolCall]:
    if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if isinstance(args, str):
        # already JSON-encoded (some templates do this); keep verbatim
        args_json = args
    else:
        args_json = json.dumps(args if args is not None else {})
    return ToolCall(name=obj["name"], arguments=args_json)


def _parse_json_calls(payload: str) -> List[ToolCall]:
    try:
        obj = json.loads(payload)
    except Exception:
        return []
    items = obj if isinstance(obj, list) else [obj]
    calls = [c for c in (_normalize_call(o) for o in items) if c]
    return calls if len(calls) == len(items) else []


def parse_tool_calls(text: str) -> Tuple[Optional[str], List[ToolCall]]:
    """Split generated text into (content, tool_calls).

    Returns (text, []) when no tool call is recognized. Content is None
    when the entire output was tool calls (OpenAI convention).
    """
    calls: List[ToolCall] = []

    # hermes/qwen: one or more <tool_call>{json}</tool_call> blocks
    if _HERMES_OPEN in text:
        content_parts = []
        rest = text
        while True:
            i = rest.find(_HERMES_OPEN)
            if i == -1:
                content_parts.append(rest)
                break
            content_parts.append(rest[:i])
            j = rest.find(_HERMES_CLOSE, i)
            payload = rest[i + len(_HERMES_OPEN): j if j != -1 else None]
            got = _parse_json_calls(payload.strip())
            if not got:  # malformed block: treat as content
                content_parts.append(rest[i:])
                break
            calls.extend(got)
            rest = rest[j + len(_HERMES_CLOSE):] if j != -1 else ""
        content = "".join(content_parts).strip()
        return (content or None, calls) if calls else (text, [])

    # mistral: [TOOL_CALLS][{...}, ...]
    i = text.find(_MISTRAL_OPEN)
    if i != -1:
        got = _parse_json_calls(text[i + len(_MISTRAL_OPEN):].strip())
        if got:
            content = text[:i].strip()
            return (content or None, got)
        return text, []

    # bare JSON (llama3 / guided forcing)
    if _BARE_RE.match(text):
        got = _parse_json_calls(text.strip())
        if got:
            return None, got
    return text, []
