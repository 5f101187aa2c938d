"""Stateful streaming detokenizer.

Equivalent of the reference's IncrementalDecoder
(reference: src/request/incremental_decoder.h:12-47): maintains
prefix_offset/output_offset so multi-token glyphs (e.g. UTF-8 continuation
bytes emitted over several steps) are only surfaced once they form valid text.
"""

from __future__ import annotations

from typing import List, Sequence as Seq


class IncrementalDecoder:
    def __init__(
        self,
        prompt: str,
        num_prompt_tokens: int,
        echo: bool = False,
        skip_special_tokens: bool = True,
    ):
        self._prompt = prompt
        self._num_prompt_tokens = num_prompt_tokens
        self._echo = echo
        self._skip_special_tokens = skip_special_tokens
        # Offsets into the token-id list: [prefix_offset, output_offset) is the
        # stable already-decoded window used as decode context.
        self._prefix_offset = 0 if echo else num_prompt_tokens
        self._output_offset = 0 if echo else num_prompt_tokens
        self._emitted_prompt = False

    @property
    def output_offset(self) -> int:
        return self._output_offset

    def decode(self, token_ids: Seq[int], tokenizer) -> str:
        """Decode any newly-finalized text from token_ids[:], given all tokens
        so far. Returns the delta string (possibly empty)."""
        delta = ""
        if self._echo and not self._emitted_prompt:
            # Surface the original prompt text verbatim instead of
            # re-detokenizing it (avoids lossy round-trips).
            if self._prompt:
                delta += self._prompt
            self._emitted_prompt = True
            self._prefix_offset = self._num_prompt_tokens
            self._output_offset = self._num_prompt_tokens

        prefix_text = tokenizer.decode(
            list(token_ids[self._prefix_offset : self._output_offset]),
            skip_special_tokens=self._skip_special_tokens,
        )
        new_text = tokenizer.decode(
            list(token_ids[self._prefix_offset :]),
            skip_special_tokens=self._skip_special_tokens,
        )
        # The replacement char means we're mid-glyph: hold back until complete.
        if len(new_text) > len(prefix_text) and not new_text.endswith("�"):
            delta += new_text[len(prefix_text) :]
            self._prefix_offset = self._output_offset
            self._output_offset = len(token_ids)
        return delta
