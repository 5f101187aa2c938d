from scalellm_tpu_torch.scheduler.continuous_scheduler import (
    ContinuousScheduler,
    SchedulerOptions,
)
from scalellm_tpu_torch.scheduler.response_handler import ResponseHandler

__all__ = ["ContinuousScheduler", "SchedulerOptions", "ResponseHandler"]
