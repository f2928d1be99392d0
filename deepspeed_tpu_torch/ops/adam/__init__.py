from .fused_adam import FusedAdam, FusedAdamState

__all__ = ["FusedAdam", "FusedAdamState"]
