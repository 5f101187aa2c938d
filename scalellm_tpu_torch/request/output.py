"""Output / status types for requests and sequences.

Re-design of the reference's output model
(reference: src/request/output.h, src/request/status.h:9).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class StatusCode(enum.Enum):
    """Request status codes (reference: src/request/status.h:9)."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    RESOURCE_EXHAUSTED = 8
    UNAUTHENTICATED = 16
    UNAVAILABLE = 14
    UNIMPLEMENTED = 12


@dataclass
class Status:
    code: StatusCode = StatusCode.OK
    message: str = ""

    @property
    def ok(self) -> bool:
        return self.code == StatusCode.OK


class FinishReason(enum.Enum):
    """Why a sequence stopped (reference: src/request/output.h FinishReason)."""

    NONE = "none"
    STOP = "stop"
    LENGTH = "length"
    FUNCTION_CALL = "function_call"

    def to_api_string(self) -> Optional[str]:
        if self == FinishReason.NONE:
            return None
        return self.value


class Priority(enum.IntEnum):
    """Scheduling priority (reference: src/request/request.h:115-135).

    Lower value = higher priority; within a class it's FCFS.
    """

    HIGH = 0
    NORMAL = 1
    LOW = 2


@dataclass
class Usage:
    """Token accounting (reference: src/request/output.h Usage)."""

    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0

    @property
    def num_total_tokens(self) -> int:
        return self.num_prompt_tokens + self.num_generated_tokens


@dataclass
class LogProbData:
    """One token's logprob entry (reference: src/request/output.h LogProbData)."""

    token: str = ""
    token_id: int = -1
    logprob: float = 0.0
    finished_token: bool = True


@dataclass
class LogProb:
    """Logprob of a sampled token plus optional top-k alternatives."""

    token: str = ""
    token_id: int = -1
    logprob: float = 0.0
    finished_token: bool = True
    top_logprobs: Optional[List[LogProbData]] = None


@dataclass
class SequenceOutput:
    """Delta or final output of one sequence
    (reference: src/request/output.h SequenceOutput)."""

    index: int = 0
    text: str = ""
    token_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    logprobs: Optional[List[LogProb]] = None


@dataclass
class RequestOutput:
    """Output of one request, possibly streamed incrementally
    (reference: src/request/output.h RequestOutput)."""

    request_id: str = ""
    prompt: Optional[str] = None
    status: Optional[Status] = None
    outputs: List[SequenceOutput] = field(default_factory=list)
    usage: Optional[Usage] = None
    finished: bool = False
    # Teacher-forced prompt logprobs (entry i scores prompt token i; entry 0
    # is None) — present when SamplingParams.prompt_logprobs was requested.
    prompt_logprobs: Optional[List[Optional[LogProb]]] = None
