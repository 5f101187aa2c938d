from scalellm_tpu_torch.models.registry import ModelRegistry

# Import model modules for their registration side effects.
from scalellm_tpu_torch.models import deepseek, llama, mistral, mixtral, qwen2, qwen2_moe  # noqa: F401

__all__ = ["ModelRegistry"]
