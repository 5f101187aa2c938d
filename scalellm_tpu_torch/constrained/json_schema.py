"""JSON Schema → regex compiler for guided JSON generation.

Covers the practical subset (outlines-style): object ``properties`` /
``required`` / ``additionalProperties: false``, ``string`` (with
``pattern``/``enum``/``const``/``minLength``/``maxLength``), ``number`` /
``integer`` (``minimum``/``maximum`` are NOT enforced — regular languages
can't compare magnitudes cleanly; generation still emits valid numerals),
``boolean``, ``null``, ``array`` (``items`` + ``minItems``/``maxItems``,
default 0..`DEFAULT_MAX_ITEMS`), ``enum``, ``anyOf``/``oneOf``, and
nested objects/arrays (schemas are finite trees, so nesting is finite).

``$ref``/recursive schemas are rejected with a clear error. The generic
"any JSON value" grammar (OpenAI ``response_format={"type":
"json_object"}``) is produced by :func:`json_value_regex` with bounded
nesting depth — the standard regular-approximation trick.

Whitespace: a single optional space is allowed after ``:`` and ``,`` —
enough for natural model output without exploding the DFA.

A copy of scalellm_tpu/constrained/json_schema.py.
"""

from __future__ import annotations

import json
import re as _re
from typing import Any, Dict, List, Optional, Union

DEFAULT_MAX_ITEMS = 16
DEFAULT_DEPTH = 4

_WS = " ?"  # optional single space
# string with standard JSON escapes, no raw control chars / quotes
_CHAR = r'(?:[^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'
STRING_RE = '"' + _CHAR + '*"'
INTEGER_RE = r"-?(?:0|[1-9]\d*)"
NUMBER_RE = INTEGER_RE + r"(?:\.\d+)?(?:[eE][+-]?\d+)?"
BOOLEAN_RE = r"(?:true|false)"
NULL_RE = r"null"


def _quote_literal(s: str) -> str:
    """Regex matching exactly the JSON string literal for s."""
    return _re.escape(json.dumps(s))


def _string_regex(schema: Dict[str, Any]) -> str:
    if "pattern" in schema:
        # pattern constrains the CONTENT between the quotes
        return '"' + schema["pattern"] + '"'
    lo = schema.get("minLength")
    hi = schema.get("maxLength")
    if lo is not None or hi is not None:
        lo = int(lo or 0)
        rep = f"{{{lo},{int(hi)}}}" if hi is not None else f"{{{lo},}}"
        return '"' + _CHAR + rep + '"'
    return STRING_RE


def _const_regex(value: Any) -> str:
    return _re.escape(json.dumps(value))


def schema_regex(schema: Union[Dict[str, Any], bool], _depth: int = 0) -> str:
    """Compile a JSON Schema node to a regex over its serialized values."""
    if _depth > 64:
        raise ValueError("schema nesting too deep (recursive $ref?)")
    if schema is True or schema == {}:
        return json_value_regex(DEFAULT_DEPTH)
    if schema is False:
        raise ValueError("schema 'false' matches nothing")
    if "$ref" in schema:
        raise ValueError("$ref is not supported in guided_json schemas")
    if "const" in schema:
        return _const_regex(schema["const"])
    if "enum" in schema:
        return "(?:" + "|".join(_const_regex(v) for v in schema["enum"]) + ")"
    for key in ("anyOf", "oneOf"):
        if key in schema:
            return (
                "(?:"
                + "|".join(schema_regex(s, _depth + 1) for s in schema[key])
                + ")"
            )

    t = schema.get("type")
    if isinstance(t, list):
        return (
            "(?:"
            + "|".join(
                schema_regex({**schema, "type": one}, _depth + 1) for one in t
            )
            + ")"
        )
    if t == "string":
        return _string_regex(schema)
    if t == "integer":
        return INTEGER_RE
    if t == "number":
        return NUMBER_RE
    if t == "boolean":
        return BOOLEAN_RE
    if t == "null":
        return NULL_RE
    if t == "array":
        item = schema.get("items", True)
        item_re = schema_regex(item, _depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", DEFAULT_MAX_ITEMS))
        hi = max(hi, lo)
        if hi == 0:
            return r"\[" + _WS + r"\]"
        more = "(?:," + _WS + item_re + ")"
        if lo == 0:
            body = "(?:" + item_re + more + f"{{0,{hi - 1}}}" + ")?"
        else:
            body = item_re + more + f"{{{lo - 1},{hi - 1}}}"
        return r"\[" + _WS + body + _WS + r"\]"
    if t == "object" or "properties" in schema:
        props: Dict[str, Any] = schema.get("properties", {})
        required = set(schema.get("required", []))
        if not props:
            # free-form object
            return _object_regex(json_value_regex(DEFAULT_DEPTH - 1))
        parts: List[str] = []
        for name, sub in props.items():
            pair = (
                _quote_literal(name) + ":" + _WS + schema_regex(sub, _depth + 1)
            )
            parts.append((name, pair) if False else pair)
        names = list(props.keys())
        # fixed property order (declaration order), optional props may be
        # omitted — the standard regular-language compromise (outlines does
        # the same); models follow the schema's order naturally.
        segs: List[str] = []
        first_emitted_any = False
        body = ""
        # build incrementally: each property contributes
        # (separator + pair), optional ones wrapped in (?:...)?.
        # separator is "," when anything could precede; to keep the regex
        # regular and simple we require: required props always present;
        # optional props each wrapped with its own leading comma variant.
        req_parts = [p for n, p in zip(names, parts) if n in required]
        opt_parts = [p for n, p in zip(names, parts) if n not in required]
        if req_parts:
            body = ("," + _WS).join(req_parts)
            for p in opt_parts:
                body += "(?:," + _WS + p + ")?"
        else:
            if not opt_parts:
                body = ""
            else:
                # all optional: first present prop has no comma
                alts = []
                for i in range(len(opt_parts)):
                    seg = opt_parts[i]
                    for p in opt_parts[i + 1 :]:
                        seg += "(?:," + _WS + p + ")?"
                    alts.append(seg)
                body = "(?:" + "|".join(alts) + ")?"
        return r"\{" + _WS + body + _WS + r"\}"
    raise ValueError(f"unsupported schema: {schema!r}")


def _object_regex(value_re: str) -> str:
    pair = STRING_RE + ":" + _WS + value_re
    return (
        r"\{" + _WS + "(?:" + pair + "(?:," + _WS + pair + ")*" + ")?" + _WS + r"\}"
    )


def json_value_regex(depth: int = DEFAULT_DEPTH) -> str:
    """Any JSON value with nesting bounded to `depth` (regular approx)."""
    scalar = (
        "(?:" + STRING_RE + "|" + NUMBER_RE + "|" + BOOLEAN_RE + "|" + NULL_RE + ")"
    )
    value = scalar
    for _ in range(depth):
        arr = r"\[" + _WS + "(?:" + value + "(?:," + _WS + value + ")*)?" + _WS + r"\]"
        obj = _object_regex(value)
        value = "(?:" + scalar + "|" + arr + "|" + obj + ")"
    return value


def json_object_regex(depth: int = DEFAULT_DEPTH) -> str:
    """Any JSON OBJECT (OpenAI json_object response format)."""
    return _object_regex(json_value_regex(depth - 1))
