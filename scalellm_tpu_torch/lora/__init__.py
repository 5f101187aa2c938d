from scalellm_tpu_torch.lora.loader import LoraMeta, load_lora_adapters

__all__ = ["LoraMeta", "load_lora_adapters"]
