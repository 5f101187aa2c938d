"""Guided-decoding front end: SamplingParams → cached TokenFsm.

Maps the user-facing constraint surface (``guided_regex`` /
``guided_json`` / ``guided_choice`` / OpenAI ``response_format``) to a
compiled :class:`TokenFsm`, with two layers of caching:

  - vocabulary byte extraction per tokenizer (expensive: V decode calls),
  - compiled (DFA + vocab binding) per (constraint, eos-ids) key.

Vocabulary byte semantics: token id → the UTF-8 bytes the token
contributes to output text. Handles the three conventions in the wild:
byte-level BPE (gpt2/llama3 — chars map through the bytes↔unicode table),
sentencepiece (``▁`` → space, ``<0xXX>`` → raw byte), and plain
char-level vocabularies (tests). Special/added control tokens get empty
bytes and are never allowed inside a constraint.

A copy of scalellm_tpu/constrained/guided.py; its errors are the port's.
"""

from __future__ import annotations

import hashlib
import json
import threading
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

from scalellm_tpu_torch.constrained.fsm import compile_regex
from scalellm_tpu_torch.constrained.json_schema import (
    json_object_regex,
    schema_regex,
)
from scalellm_tpu_torch.constrained.tokenmap import GuidedState, TokenFsm


@lru_cache(maxsize=8)
def _gpt2_unicode_to_byte() -> Dict[str, int]:
    """Inverse of GPT-2's bytes_to_unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def token_vocab_bytes(tokenizer) -> List[bytes]:
    """Byte string each vocab id contributes to output text."""
    cached = getattr(tokenizer, "_vocab_bytes_cache", None)
    if cached is not None:
        return cached

    V = tokenizer.vocab_size
    # tiktoken exposes exact bytes directly
    enc = getattr(tokenizer, "_enc", None)
    if enc is not None and hasattr(enc, "decode_single_token_bytes"):
        out: List[bytes] = []
        for v in range(V):
            try:
                out.append(enc.decode_single_token_bytes(v))
            except Exception:
                out.append(b"")
        tokenizer._vocab_bytes_cache = out
        return out

    toks = [tokenizer.id_to_token(v) or "" for v in range(V)]
    inv = _gpt2_unicode_to_byte()
    sp_style = any(t.startswith("▁") or _is_byte_token(t) for t in toks)
    byte_level = not sp_style and toks and all(
        all(ch in inv for ch in t) for t in toks if t and not _looks_special(t)
    )

    out = []
    for t in toks:
        if not t or _looks_special(t):
            out.append(b"")
        elif sp_style:
            if _is_byte_token(t):
                out.append(bytes([int(t[1:-1], 16)]))
            else:
                out.append(t.replace("▁", " ").encode("utf-8"))
        elif byte_level:
            out.append(bytes(inv[ch] for ch in t))
        else:
            out.append(t.encode("utf-8"))
    tokenizer._vocab_bytes_cache = out
    return out


def _is_byte_token(t: str) -> bool:
    return (
        len(t) == 6 and t.startswith("<0x") and t.endswith(">")
    )


def _looks_special(t: str) -> bool:
    return len(t) > 2 and t.startswith("<") and t.endswith(">") and not _is_byte_token(t)


# ------------------------------------------------------------- constraint key


def constraint_regex(sp) -> Optional[str]:
    """The regex for a SamplingParams' guided constraint, or None."""
    n_set = sum(
        x is not None and x != ""
        for x in (
            getattr(sp, "guided_regex", None),
            getattr(sp, "guided_json", None),
            getattr(sp, "guided_choice", None),
        )
    )
    if n_set == 0:
        return None
    if n_set > 1:
        from scalellm_tpu_torch.errors import ValidationError
        from scalellm_tpu_torch.request.output import StatusCode

        raise ValidationError(
            StatusCode.INVALID_ARGUMENT,
            "at most one of guided_regex/guided_json/guided_choice may be set",
        )
    if sp.guided_regex:
        return sp.guided_regex
    if sp.guided_choice:
        import re as _re

        return "|".join("(?:" + _re.escape(c) + ")" for c in sp.guided_choice)
    gj = sp.guided_json
    if gj in ("object", True):  # response_format json_object
        return json_object_regex()
    if isinstance(gj, str):
        gj = json.loads(gj)
    return schema_regex(gj)


class FsmCache:
    """Compiled TokenFsm cache shared by handler threads."""

    def __init__(self, max_entries: int = 64):
        self._lock = threading.Lock()
        self._cache: Dict[str, TokenFsm] = {}
        self._max = max_entries

    def get(
        self, regex: str, tokenizer, eos_token_ids: Tuple[int, ...]
    ) -> TokenFsm:
        key = hashlib.sha256(
            (regex + "|" + ",".join(map(str, sorted(eos_token_ids)))).encode()
        ).hexdigest()
        with self._lock:
            fsm = self._cache.get(key)
        if fsm is not None:
            return fsm
        vocab = token_vocab_bytes(tokenizer)
        dfa = compile_regex(regex)
        fsm = TokenFsm(dfa, vocab, eos_token_ids)
        with self._lock:
            if len(self._cache) >= self._max:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = fsm
        return fsm


def make_guided_state(fsm: Optional[TokenFsm]) -> Optional[GuidedState]:
    return GuidedState(fsm) if fsm is not None else None
