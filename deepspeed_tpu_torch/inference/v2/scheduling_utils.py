"""Admission-control results (copy of
``deepspeed_tpu/inference/v2/scheduling_utils.py``)."""

import enum


class SchedulingResult(enum.Enum):
    Success = 0
    EngineSequenceLimitExceeded = 1
    BatchSequenceLimitExceeded = 2
    TokenLimitExceeded = 3
    KVCacheLimitExceeded = 4


class SchedulingError(RuntimeError):

    def __init__(self, result: SchedulingResult):
        self.status = result
        super().__init__(f"Scheduling failed: {result.name}")
