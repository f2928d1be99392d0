from .cpu_adam import DeepSpeedCPUAdam
from .fused_adam import FusedAdam, FusedAdamState

__all__ = ["DeepSpeedCPUAdam", "FusedAdam", "FusedAdamState"]
