from .async_swapper import AsyncTensorSwapper
from .optimizer_utils import OptimizerStateSwapper
from .partitioned_param_swapper import AsyncPartitionedParameterSwapper

__all__ = ["AsyncTensorSwapper", "AsyncPartitionedParameterSwapper", "OptimizerStateSwapper"]
