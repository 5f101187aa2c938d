"""OpenAI API request/response models.

A copy of scalellm_tpu/serve/api_protocol.py, its imports pointed at this
package's errors, request.output, sampling.params and utils.tools: plain
dataclasses and hand validation with the same messages and status codes;
the JSON field names and shapes match the OpenAI API.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Union

from scalellm_tpu_torch.errors import ValidationError
from scalellm_tpu_torch.request.output import StatusCode
from scalellm_tpu_torch.sampling.params import SamplingParams


def _bad(msg: str):
    raise ValidationError(StatusCode.INVALID_ARGUMENT, msg)


def _get(d: Dict[str, Any], key: str, typ, default=None):
    v = d.get(key, default)
    if v is None:
        return default
    if typ is float and isinstance(v, int):
        v = float(v)
    if not isinstance(v, typ):
        _bad(f"invalid type for {key!r}")
    return v



def _parse_logit_bias(d: Dict[str, Any]) -> Optional[Dict[int, float]]:
    """OpenAI logit_bias: JSON map of token-id STRING -> bias number."""
    lb = d.get("logit_bias")
    if lb is None:
        return None
    if not isinstance(lb, dict):
        _bad("logit_bias must be an object mapping token ids to numbers")
    out: Dict[int, float] = {}
    for k, v in lb.items():
        try:
            tid = int(k)
        except (TypeError, ValueError):
            _bad("logit_bias keys must be integer token ids")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            _bad("logit_bias values must be numbers")
        out[tid] = float(v)
    return out or None


def _parse_guided(d: Dict[str, Any]) -> Dict[str, Any]:
    """Guided-decoding fields: OpenAI response_format plus the vLLM-style
    guided_regex / guided_json / guided_choice extensions."""
    out: Dict[str, Any] = {
        "guided_regex": None, "guided_json": None, "guided_choice": None,
    }
    rf = d.get("response_format")
    if rf is not None:
        if not isinstance(rf, dict) or "type" not in rf:
            _bad("response_format must be an object with a 'type'")
        t = rf["type"]
        if t == "json_object":
            out["guided_json"] = "object"
        elif t == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict):
                _bad("response_format json_schema requires a 'json_schema' object")
            out["guided_json"] = js.get("schema", js)
        elif t != "text":
            _bad(f"unsupported response_format type {t!r}")
    if d.get("guided_regex") is not None:
        out["guided_regex"] = _get(d, "guided_regex", str)
    if d.get("guided_json") is not None:
        gj = d["guided_json"]
        if not isinstance(gj, (dict, str)):
            _bad("guided_json must be a schema object or JSON string")
        out["guided_json"] = gj
    if d.get("guided_choice") is not None:
        gc = d["guided_choice"]
        if not isinstance(gc, list) or not all(isinstance(c, str) for c in gc):
            _bad("guided_choice must be a list of strings")
        out["guided_choice"] = gc
    return out


@dataclass
class CompletionRequest:
    """POST /v1/completions body (reference: api_protocol.py CompletionRequest)."""

    model: str = ""
    prompt: Union[str, List[str]] = ""
    best_of: Optional[int] = None
    echo: bool = False
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logprobs: Optional[int] = None
    max_tokens: int = 16
    n: int = 1
    seed: Optional[int] = None
    stop: Optional[List[str]] = None
    stop_token_ids: Optional[List[int]] = None
    stream: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    user: Optional[str] = None
    ignore_eos: bool = False
    skip_special_tokens: bool = True
    priority: str = "normal"  # "high" | "normal" | "low"
    logit_bias: Optional[Dict[int, float]] = None
    guided_regex: Optional[str] = None
    guided_json: Optional[Any] = None
    guided_choice: Optional[List[str]] = None

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "CompletionRequest":
        if not isinstance(d, dict):
            _bad("request body must be a JSON object")
        prompt = d.get("prompt", "")
        if isinstance(prompt, list):
            if not all(isinstance(p, str) for p in prompt):
                _bad("prompt must be a string or list of strings")
        elif not isinstance(prompt, str):
            _bad("prompt must be a string or list of strings")
        stop = d.get("stop")
        if isinstance(stop, str):
            stop = [stop]
        return cls(
            model=_get(d, "model", str, ""),
            prompt=prompt,
            best_of=_get(d, "best_of", int),
            echo=_get(d, "echo", bool, False),
            frequency_penalty=_get(d, "frequency_penalty", float, 0.0),
            presence_penalty=_get(d, "presence_penalty", float, 0.0),
            repetition_penalty=_get(d, "repetition_penalty", float, 1.0),
            logprobs=_get(d, "logprobs", int),
            max_tokens=_get(d, "max_tokens", int, 16),
            n=_get(d, "n", int, 1),
            seed=_get(d, "seed", int),
            stop=stop,
            stop_token_ids=d.get("stop_token_ids"),
            stream=_get(d, "stream", bool, False),
            temperature=_get(d, "temperature", float, 1.0),
            top_p=_get(d, "top_p", float, 1.0),
            top_k=_get(d, "top_k", int, -1),
            user=_get(d, "user", str),
            ignore_eos=_get(d, "ignore_eos", bool, False),
            skip_special_tokens=_get(d, "skip_special_tokens", bool, True),
            priority=_get(d, "priority", str, "normal"),
            logit_bias=_parse_logit_bias(d),
            **_parse_guided(d),
        )

    def to_priority(self):
        from scalellm_tpu_torch.request.output import Priority

        return {"high": Priority.HIGH, "low": Priority.LOW}.get(
            self.priority, Priority.NORMAL
        )

    def to_sampling_params(self) -> SamplingParams:
        sp = SamplingParams(
            max_tokens=self.max_tokens,
            n=self.n,
            best_of=self.best_of,
            echo=self.echo,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            repetition_penalty=self.repetition_penalty,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            logprobs=self.logprobs is not None,
            top_logprobs=self.logprobs or 0,
            skip_special_tokens=self.skip_special_tokens,
            ignore_eos=self.ignore_eos,
            stop=self.stop,
            stop_token_ids=self.stop_token_ids,
            seed=self.seed,
            logit_bias=self.logit_bias,
            guided_regex=self.guided_regex,
            guided_json=self.guided_json,
            guided_choice=self.guided_choice,
            # OpenAI: echo=True with logprobs=N also returns logprobs of
            # the prompt tokens (with N alternatives per position).
            prompt_logprobs=self.logprobs
            if self.echo and self.logprobs is not None
            else None,
        )
        return sp


@dataclass
class ChatCompletionRequest:
    """POST /v1/chat/completions body
    (reference: api_protocol.py ChatCompletionRequest)."""

    model: str = ""
    messages: List[Dict[str, str]] = field(default_factory=list)
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logprobs: bool = False
    top_logprobs: int = 0
    max_tokens: int = 16
    n: int = 1
    seed: Optional[int] = None
    stop: Optional[List[str]] = None
    stop_token_ids: Optional[List[int]] = None
    stream: bool = False
    temperature: float = 0.7
    top_p: float = 1.0
    top_k: int = -1
    user: Optional[str] = None
    ignore_eos: bool = False
    skip_special_tokens: bool = True
    priority: str = "normal"
    logit_bias: Optional[Dict[int, float]] = None
    guided_regex: Optional[str] = None
    guided_json: Optional[Any] = None
    guided_choice: Optional[List[str]] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Any = "auto"

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ChatCompletionRequest":
        if not isinstance(d, dict):
            _bad("request body must be a JSON object")
        messages = d.get("messages")
        if not isinstance(messages, list) or not messages:
            _bad("messages must be a non-empty list")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m:
                _bad("each message needs 'role' and 'content'")
            # assistant tool-call turns may carry content: null; everything
            # else needs content (OpenAI semantics)
            if m.get("content") is None and not m.get("tool_calls"):
                _bad("each message needs 'role' and 'content'")
        tools = d.get("tools")
        tool_choice = d.get("tool_choice")
        try:
            from scalellm_tpu_torch.utils.tools import (
                validate_tool_choice,
                validate_tools,
            )

            if tools is not None:
                tools = validate_tools(tools)
            tool_choice = validate_tool_choice(tool_choice, tools)
        except ValueError as e:
            _bad(str(e))
        stop = d.get("stop")
        if isinstance(stop, str):
            stop = [stop]
        return cls(
            model=_get(d, "model", str, ""),
            messages=messages,
            frequency_penalty=_get(d, "frequency_penalty", float, 0.0),
            presence_penalty=_get(d, "presence_penalty", float, 0.0),
            repetition_penalty=_get(d, "repetition_penalty", float, 1.0),
            logprobs=_get(d, "logprobs", bool, False),
            top_logprobs=_get(d, "top_logprobs", int, 0),
            max_tokens=_get(d, "max_tokens", int, 16),
            n=_get(d, "n", int, 1),
            seed=_get(d, "seed", int),
            stop=stop,
            stop_token_ids=d.get("stop_token_ids"),
            stream=_get(d, "stream", bool, False),
            temperature=_get(d, "temperature", float, 0.7),
            top_p=_get(d, "top_p", float, 1.0),
            top_k=_get(d, "top_k", int, -1),
            user=_get(d, "user", str),
            ignore_eos=_get(d, "ignore_eos", bool, False),
            skip_special_tokens=_get(d, "skip_special_tokens", bool, True),
            priority=_get(d, "priority", str, "normal"),
            logit_bias=_parse_logit_bias(d),
            tools=tools,
            tool_choice=tool_choice,
            **_parse_guided(d),
        )

    def to_priority(self):
        from scalellm_tpu_torch.request.output import Priority

        return {"high": Priority.HIGH, "low": Priority.LOW}.get(
            self.priority, Priority.NORMAL
        )

    @property
    def tools_active(self) -> bool:
        return bool(self.tools) and self.tool_choice != "none"

    def _forced_tool_regex(self) -> Optional[str]:
        """Guided constraint when tool_choice forces a call."""
        if not self.tools_active:
            return None
        from scalellm_tpu_torch.utils.tools import guided_regex_for_tools

        if self.tool_choice == "required":
            return guided_regex_for_tools(self.tools)
        if isinstance(self.tool_choice, dict):
            return guided_regex_for_tools(
                self.tools, self.tool_choice["function"]["name"]
            )
        return None

    def to_sampling_params(self) -> SamplingParams:
        forced = self._forced_tool_regex()
        if forced is not None and (
            self.guided_regex or self.guided_json or self.guided_choice
        ):
            _bad("tool_choice forcing cannot be combined with guided_* params")
        return SamplingParams(
            max_tokens=self.max_tokens,
            n=self.n,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            repetition_penalty=self.repetition_penalty,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            logprobs=self.logprobs,
            top_logprobs=self.top_logprobs,
            skip_special_tokens=self.skip_special_tokens,
            ignore_eos=self.ignore_eos,
            stop=self.stop,
            stop_token_ids=self.stop_token_ids,
            seed=self.seed,
            logit_bias=self.logit_bias,
            guided_regex=forced or self.guided_regex,
            guided_json=self.guided_json,
            guided_choice=self.guided_choice,
        )


def now() -> int:
    return int(time.time())


def error_json(message: str, typ: str = "invalid_request_error", code: int = 400):
    return {"error": {"message": message, "type": typ, "code": code}}


def status_to_http(code: StatusCode) -> int:
    """(reference: api_server.py ValidationError → HTTP mapping)"""
    return {
        StatusCode.OK: 200,
        StatusCode.CANCELLED: 499,
        StatusCode.UNKNOWN: 500,
        StatusCode.INVALID_ARGUMENT: 400,
        StatusCode.DEADLINE_EXCEEDED: 504,
        StatusCode.RESOURCE_EXHAUSTED: 429,
        StatusCode.UNAUTHENTICATED: 401,
        StatusCode.UNAVAILABLE: 503,
        StatusCode.UNIMPLEMENTED: 501,
    }.get(code, 500)
