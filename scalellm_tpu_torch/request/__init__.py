from scalellm_tpu_torch.request.output import (
    FinishReason,
    LogProb,
    LogProbData,
    Priority,
    RequestOutput,
    SequenceOutput,
    Status,
    StatusCode,
    Usage,
)
from scalellm_tpu_torch.request.stopping import StoppingCriteria
from scalellm_tpu_torch.request.sequence import EngineType, Sequence
from scalellm_tpu_torch.request.request import Request
from scalellm_tpu_torch.request.incremental_decoder import IncrementalDecoder

__all__ = [
    "FinishReason",
    "LogProb",
    "LogProbData",
    "Priority",
    "RequestOutput",
    "SequenceOutput",
    "Status",
    "StatusCode",
    "Usage",
    "StoppingCriteria",
    "EngineType",
    "Sequence",
    "Request",
    "IncrementalDecoder",
]
