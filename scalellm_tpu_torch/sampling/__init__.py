from scalellm_tpu_torch.sampling.params import SamplingParams

__all__ = ["SamplingParams"]
