from scalellm_tpu_torch.model_loader.loader import HFModelLoader

__all__ = ["HFModelLoader"]
