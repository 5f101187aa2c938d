"""User-facing sampling parameters.

Mirrors the reference's SamplingParams surface
(reference: src/handlers/sampling_params.h:13, scalellm/csrc/sampling_params.cpp).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class SamplingParams:
    # Number of tokens to generate.
    max_tokens: int = 16
    # Number of sequences to return for the prompt.
    n: int = 1
    # Number of sequences to generate; returns the best n of best_of.
    best_of: Optional[int] = None
    # Include the prompt in the returned text.
    echo: bool = False
    # Penalties.
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    # Randomness.
    temperature: float = 0.7
    top_p: float = 1.0
    top_k: int = -1
    # Logprobs of sampled tokens (and top_logprobs alternatives).
    logprobs: bool = False
    top_logprobs: int = 0
    # Teacher-forced logprobs of the PROMPT tokens: None = off; k >= 0 also
    # returns the top-k alternatives per prompt position.
    prompt_logprobs: Optional[int] = None
    # Eos/stop handling.
    skip_special_tokens: bool = True
    ignore_eos: bool = False
    stop: Optional[List[str]] = None
    stop_token_ids: Optional[List[int]] = None
    # Optional RNG seed for reproducible sampling.
    seed: Optional[int] = None
    # Additive per-token logit bias (token id -> bias, OpenAI semantics:
    # values in [-100, 100]; -100 effectively bans a token). Applied to the
    # raw logits before penalties/temperature.
    logit_bias: Optional[Dict[int, float]] = None
    # Guided (grammar-constrained) decoding — at most one may be set.
    # Capability extension beyond the reference engine (vLLM-style).
    # Regex (full-match) the generated text must follow.
    guided_regex: Optional[str] = None
    # JSON Schema (dict or JSON string); the literal "object" means any
    # JSON object (OpenAI response_format={"type": "json_object"}).
    guided_json: "Optional[object]" = None
    # Output must be exactly one of these strings.
    guided_choice: Optional[List[str]] = None

    def __post_init__(self):
        if self.best_of is None:
            self.best_of = self.n

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0

    def verify(self) -> None:
        """Raises ValidationError on bad params
        (reference: llm_handler.cpp:103-164 verify_params)."""
        from scalellm_tpu_torch.errors import ValidationError
        from scalellm_tpu_torch.request.output import StatusCode

        def bad(msg):
            raise ValidationError(StatusCode.INVALID_ARGUMENT, msg)

        if self.max_tokens < 1:
            bad("max_tokens must be at least 1")
        if self.n < 1:
            bad("n must be at least 1")
        if self.best_of is not None and self.best_of < self.n:
            bad("best_of must be >= n")
        if not 0.0 <= self.temperature:
            bad("temperature must be non-negative")
        if not 0.0 < self.top_p <= 1.0:
            bad("top_p must be in (0, 1]")
        if self.top_k < -1 or self.top_k == 0:
            bad("top_k must be -1 (disabled) or >= 1")
        if not -2.0 <= self.frequency_penalty <= 2.0:
            bad("frequency_penalty must be in [-2, 2]")
        if not -2.0 <= self.presence_penalty <= 2.0:
            bad("presence_penalty must be in [-2, 2]")
        if self.repetition_penalty <= 0.0:
            bad("repetition_penalty must be > 0")
        if self.top_logprobs < 0 or self.top_logprobs > 20:
            bad("top_logprobs must be in [0, 20]")
        if self.prompt_logprobs is not None and not (
            0 <= self.prompt_logprobs <= 20
        ):
            bad("prompt_logprobs must be in [0, 20]")
        if self.logit_bias is not None:
            if len(self.logit_bias) > 1024:
                bad("logit_bias supports at most 1024 tokens")
            for tid, b in self.logit_bias.items():
                if not isinstance(tid, int) or tid < 0:
                    bad("logit_bias keys must be non-negative token ids")
                if not -100.0 <= float(b) <= 100.0:
                    bad("logit_bias values must be in [-100, 100]")
        n_guided = sum(
            x is not None and x != ""
            for x in (self.guided_regex, self.guided_json, self.guided_choice)
        )
        if n_guided > 1:
            bad("at most one of guided_regex/guided_json/guided_choice")
        if self.guided_choice is not None and (
            not self.guided_choice
            or not all(isinstance(c, str) and c for c in self.guided_choice)
        ):
            bad("guided_choice must be a non-empty list of non-empty strings")

    @property
    def has_guided(self) -> bool:
        return any(
            x is not None and x != ""
            for x in (self.guided_regex, self.guided_json, self.guided_choice)
        )
