"""scalellm_tpu_torch — the PyTorch/CUDA port of the scalellm_tpu package.

Serves a Llama-family decoder on an NVIDIA GPU (Hopper): continuous batching
over a paged KV cache with chunked prefill and the prefix cache, with the
ragged paged attention as a hand-written CUDA kernel
(csrc/ragged_paged_attention.cu). Modules mirror scalellm_tpu's paths and
names. It imports torch, and neither jax nor the scalellm_tpu package.

Public API:
  - LLM: synchronous offline batch inference
  - AsyncLLMEngine: async serving engine (OutputStream, OutputAsyncStream)
  - SamplingParams, Message, Priority, RequestOutput, ...
"""

from scalellm_tpu_torch.version import __version__

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
from scalellm_tpu_torch.sampling.params import SamplingParams
from scalellm_tpu_torch.utils.chat import Message
from scalellm_tpu_torch.errors import ValidationError


def __getattr__(name):
    # Lazy: `import scalellm_tpu_torch` loads no model, engine or kernel code.
    if name == "LLM":
        from scalellm_tpu_torch.llm import LLM

        return LLM
    if name in ("AsyncLLMEngine", "OutputStream", "OutputAsyncStream"):
        from scalellm_tpu_torch import llm_engine

        return getattr(llm_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "__version__",
    "LLM",
    "AsyncLLMEngine",
    "OutputStream",
    "OutputAsyncStream",
    "SamplingParams",
    "Message",
    "Priority",
    "RequestOutput",
    "SequenceOutput",
    "Status",
    "StatusCode",
    "Usage",
    "LogProb",
    "LogProbData",
    "FinishReason",
    "ValidationError",
]
