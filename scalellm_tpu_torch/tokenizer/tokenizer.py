"""Tokenizer layer (counterpart of scalellm_tpu/tokenizer/tokenizer.py).

A tokenizer.json whose model is WordLevel, split into single characters (the
char tokenizer of tests/fixtures.py:save_char_tokenizer), is read here
without the `tokenizers` package. Any other tokenizer.json goes through
`tokenizers`, imported only then.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


class WordLevelTokenizer:
    """A WordLevel tokenizer.json whose pre-tokenizer splits the text into
    single characters (Split on "" with the Isolated behaviour) and whose
    decoder fuses the tokens back together. Characters outside the vocab
    map to the unk token; ids with no token decode to ""."""

    def __init__(self, spec: Dict, chat_template: Optional[str] = None):
        model = spec["model"]
        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._unk_id = self._vocab.get(model.get("unk_token"))
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        for added in spec.get("added_tokens") or []:
            self._vocab[added["content"]] = added["id"]
            self._id_to_token[added["id"]] = added["content"]
        self._special_ids = {
            a["id"] for a in spec.get("added_tokens") or [] if a.get("special")
        }
        self.chat_template = chat_template

    @staticmethod
    def handles(spec: Dict) -> bool:
        pre = spec.get("pre_tokenizer") or {}
        return (
            spec.get("model", {}).get("type") == "WordLevel"
            and pre.get("type") == "Split"
            and pre.get("pattern") == {"String": ""}
            and pre.get("behavior") == "Isolated"
            and not pre.get("invert", False)
            and spec.get("normalizer") is None
            and spec.get("post_processor") is None
            and (spec.get("decoder") or {}).get("type") == "Fuse"
        )

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = []
        for ch in text:
            tid = self._vocab.get(ch, self._unk_id)
            if tid is None:
                raise ValueError(f"character {ch!r} is not in the vocab and there is no unk token")
            ids.append(tid)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return "".join(
            self._id_to_token.get(int(i), "")
            for i in ids
            if not (skip_special_tokens and int(i) in self._special_ids)
        )

    def id_to_token(self, token_id: int) -> str:
        return self._id_to_token.get(int(token_id), "")

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    def clone(self) -> "WordLevelTokenizer":
        return self


class HFTokenizer:
    """Wraps a fast `tokenizers.Tokenizer` (tokenizer.json)."""

    def __init__(self, tok, chat_template: Optional[str] = None):
        self._tok = tok
        self.chat_template = chat_template

    @classmethod
    def from_file(cls, path: str, chat_template: Optional[str] = None) -> "HFTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(path), chat_template)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def id_to_token(self, token_id: int) -> str:
        t = self._tok.id_to_token(int(token_id))
        return t if t is not None else ""

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def clone(self) -> "HFTokenizer":
        return self


def load_tokenizer(model_path: str, chat_template: Optional[str] = None):
    """The tokenizer of a model folder's tokenizer.json."""
    if chat_template is None:
        tc = os.path.join(model_path, "tokenizer_config.json")
        if os.path.exists(tc):
            with open(tc) as f:
                chat_template = json.load(f).get("chat_template")
    tj = os.path.join(model_path, "tokenizer.json")
    if not os.path.exists(tj):
        raise NotImplementedError(
            f"{model_path}: only tokenizer.json folders are ported "
            "(tiktoken and sentencepiece tokenizers are not)"
        )
    with open(tj) as f:
        spec = json.load(f)
    if WordLevelTokenizer.handles(spec):
        return WordLevelTokenizer(spec, chat_template)
    return HFTokenizer.from_file(tj, chat_template)
