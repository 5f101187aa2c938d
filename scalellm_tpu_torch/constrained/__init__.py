"""Grammar-constrained (guided) decoding
(counterpart of scalellm_tpu/constrained/, copied: numpy and the standard
library only).

Regex / JSON-schema / choice-list constrained generation, vLLM-style.
Byte-level DFAs (fsm.py) bound to the tokenizer vocabulary (tokenmap.py)
produce per-step packed allowed-token bitmasks, applied by the sampler
after the step's forward (sampling/sampler.py:apply_allowed_mask).
"""

from scalellm_tpu_torch.constrained.fsm import Dfa, compile_regex
from scalellm_tpu_torch.constrained.guided import (
    FsmCache,
    constraint_regex,
    token_vocab_bytes,
)
from scalellm_tpu_torch.constrained.json_schema import (
    json_object_regex,
    json_value_regex,
    schema_regex,
)
from scalellm_tpu_torch.constrained.tokenmap import GuidedState, TokenFsm

__all__ = [
    "Dfa",
    "compile_regex",
    "FsmCache",
    "constraint_regex",
    "token_vocab_bytes",
    "json_object_regex",
    "json_value_regex",
    "schema_regex",
    "GuidedState",
    "TokenFsm",
]
