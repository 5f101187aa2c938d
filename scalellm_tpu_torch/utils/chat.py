"""Chat messages and template application
(counterpart of scalellm_tpu/utils/chat.py).

A jinja chat_template from tokenizer_config.json runs in a sandboxed jinja2
environment (jinja2 is imported only then); otherwise the model family's
coded template applies. Tool definitions pass through to jinja templates
that accept ``tools=`` (the HF convention); the coded templates get a
generated system block (utils/tools.py), and tool calls and results become
text turns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence


@dataclass
class Message:
    role: str
    content: Optional[str] = None
    # assistant messages that previously called tools
    tool_calls: Optional[List[Dict[str, Any]]] = None
    # role == "tool" result messages
    tool_call_id: Optional[str] = None
    name: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"role": self.role, "content": self.content}
        if self.tool_calls is not None:
            d["tool_calls"] = self.tool_calls
        if self.tool_call_id is not None:
            d["tool_call_id"] = self.tool_call_id
        if self.name is not None:
            d["name"] = self.name
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Message":
        return cls(
            role=d.get("role", "user"),
            content=d.get("content"),
            tool_calls=d.get("tool_calls"),
            tool_call_id=d.get("tool_call_id"),
            name=d.get("name"),
        )


def apply_chat_template(
    messages: Sequence[Message],
    jinja_template: Optional[str] = None,
    model_type: str = "",
    tools: Optional[Sequence[Dict[str, Any]]] = None,
) -> str:
    if jinja_template:
        try:
            return _render_jinja(jinja_template, messages, tools)
        except Exception:
            pass  # fall through to the coded template
    from scalellm_tpu_torch.models.registry import ModelRegistry

    coded = ModelRegistry.get_default_chat_template(model_type)
    if coded is None:
        raise ValueError(f"no chat template available for model type {model_type!r}")
    return coded(_flatten_for_coded(messages, tools))


def _flatten_for_coded(
    messages: Sequence[Message], tools: Optional[Sequence[Dict[str, Any]]]
) -> List[Message]:
    """Coded templates know only system/user/assistant text turns: tool
    definitions become a system block, tool calls/results become text."""
    import json

    out: List[Message] = []
    if tools:
        from scalellm_tpu_torch.utils.tools import render_tools_block

        out.append(Message("system", render_tools_block(tools)))
    for m in messages:
        if m.role == "tool":
            out.append(Message("user", f"<tool_response>{m.content}</tool_response>"))
        elif m.tool_calls:
            calls = "\n".join(json.dumps(tc.get("function", tc)) for tc in m.tool_calls)
            out.append(Message("assistant", (m.content or "") + calls))
        else:
            out.append(Message(m.role, m.content or ""))
    return out


def _render_jinja(
    template: str,
    messages: Sequence[Message],
    tools: Optional[Sequence[Dict[str, Any]]] = None,
) -> str:
    import jinja2
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    # Sandboxed: checkpoint-supplied templates are untrusted input.
    env = ImmutableSandboxedEnvironment(
        loader=jinja2.BaseLoader(), trim_blocks=True, lstrip_blocks=True
    )
    env.globals["raise_exception"] = _raise_exception
    env.filters["tojson"] = _tojson
    return env.from_string(template).render(
        messages=[m.to_dict() for m in messages],
        tools=list(tools) if tools else None,
        add_generation_prompt=True,
    )


def _tojson(value, indent=None):
    import json

    return json.dumps(value, ensure_ascii=False, indent=indent)


def _raise_exception(msg):
    raise ValueError(msg)
