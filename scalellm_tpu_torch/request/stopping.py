"""Stopping criteria for generation.

Equivalent of the reference's StoppingCriteria
(reference: src/request/stopping_criteria.h:14-17).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence as Seq, Set, Tuple

from scalellm_tpu_torch.request.output import FinishReason


@dataclass
class StoppingCriteria:
    """Decides when a sequence is finished.

    Checks, in order: stop token ids, stop token-sequences, max_tokens,
    max_context_len (mirrors reference check_finished semantics:
    src/request/stopping_criteria.h:17).
    """

    # Max new (generated) tokens.
    max_tokens: int = 16
    # eos token id; ignored if ignore_eos.
    eos_token_id: int = -1
    ignore_eos: bool = False
    # Token ids that stop generation (the stop token is NOT part of output text).
    stop_token_ids: Set[int] = field(default_factory=set)
    # Token-id sequences whose suffix-match stops generation.
    stop_sequences: List[List[int]] = field(default_factory=list)
    # Hard cap on total context length (prompt + generated).
    max_context_len: int = 0

    def check_finished(
        self, token_ids: Seq[int], num_prompt_tokens: int
    ) -> Tuple[FinishReason, Optional[int]]:
        """Returns (finish_reason, num_trailing_tokens_to_hide).

        num_trailing_tokens_to_hide is how many trailing tokens belong to the
        stop match and should be excluded from output text (None if not
        finished or nothing to hide).
        """
        num_generated = len(token_ids) - num_prompt_tokens
        if num_generated <= 0:
            return FinishReason.NONE, None

        last_token = token_ids[-1]
        if not self.ignore_eos and last_token == self.eos_token_id:
            return FinishReason.STOP, 1
        if last_token in self.stop_token_ids:
            return FinishReason.STOP, 1

        for stop_seq in self.stop_sequences:
            n = len(stop_seq)
            if n > 0 and len(token_ids) >= n and list(token_ids[-n:]) == list(stop_seq):
                return FinishReason.STOP, n

        if num_generated >= self.max_tokens:
            return FinishReason.LENGTH, None
        if self.max_context_len > 0 and len(token_ids) >= self.max_context_len:
            return FinishReason.LENGTH, None
        return FinishReason.NONE, None
