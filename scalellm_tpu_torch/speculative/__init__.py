from scalellm_tpu_torch.speculative.rejection_sampler import rejection_sample, rejection_sample_onehot
from scalellm_tpu_torch.speculative.speculative_engine import SpeculativeEngine

__all__ = ["rejection_sample", "rejection_sample_onehot", "SpeculativeEngine"]
