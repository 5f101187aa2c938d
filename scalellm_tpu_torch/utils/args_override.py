"""CLI overrides for loaded model args (reference parity:
src/model_loader/args_overrider.h — ops can override any
ModelArgs/QuantArgs/TokenizerArgs field from gflags; here the same
capability as repeatable `--model-args-override field=value` flags,
surfaced on the servers' /config endpoint).

A copy of scalellm_tpu/utils/args_override.py.

Paths are dotted into nested dataclasses: `rope_theta=1e6`,
`quant_args.bits=8`, `n_layers=16`. Values are coerced to the CURRENT
field's type (bool accepts true/false/1/0; None-valued fields get
literal-eval'd).
"""

from __future__ import annotations

import ast
import dataclasses
import logging
from typing import Any, Iterable, List

logger = logging.getLogger(__name__)


def _coerce(cur: Any, raw: str) -> Any:
    if isinstance(cur, bool):
        low = raw.strip().lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"not a bool: {raw!r}")
    if isinstance(cur, int) and not isinstance(cur, bool):
        return int(float(raw))  # accept "1e6"
    if isinstance(cur, float):
        return float(raw)
    if isinstance(cur, str):
        return raw
    # None / lists / dicts: literal-eval, falling back to the raw string.
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def apply_overrides(obj: Any, overrides: Iterable[str]) -> List[str]:
    """Apply `path=value` overrides in place; returns the applied list
    (for /config display). Unknown fields raise ValueError (a typo that
    silently no-ops is worse than a crash at startup)."""
    applied = []
    for ov in overrides or ():
        if "=" not in ov:
            raise ValueError(f"--model-args-override needs field=value: {ov!r}")
        path, raw = ov.split("=", 1)
        parts = path.strip().split(".")
        target = obj
        for p in parts[:-1]:
            if not hasattr(target, p):
                raise ValueError(f"unknown model-args path: {path!r}")
            target = getattr(target, p)
            if target is None:
                raise ValueError(f"{path!r}: {p!r} is None on this model")
        field = parts[-1]
        if not (dataclasses.is_dataclass(target) and hasattr(target, field)):
            raise ValueError(f"unknown model-args field: {path!r}")
        cur = getattr(target, field)
        val = _coerce(cur, raw)
        setattr(target, field, val)
        applied.append(f"{path}={val!r}")
        logger.info("model-args override: %s = %r (was %r)", path, val, cur)
    return applied
