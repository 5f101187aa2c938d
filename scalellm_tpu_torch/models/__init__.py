from scalellm_tpu_torch.models.registry import ModelRegistry

# Import model modules for their registration side effects.
from scalellm_tpu_torch.models import (  # noqa: F401
    bloom, deepseek, gemma, gemma2, gpt2, llama, mistral, mixtral, mpt, phi, qwen, qwen2, qwen2_moe,
)

__all__ = ["ModelRegistry"]
