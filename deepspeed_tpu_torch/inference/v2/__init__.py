"""FastGen-style inference v2 for the PyTorch port: ragged continuous
batching over a paged KV cache, served by hand-written CUDA paged-attention
kernels."""

from .config_v2 import (DSStateManagerConfig, ModulesConfig, PrefixCacheConfig,
                        RaggedInferenceEngineConfig, SpeculativeConfig)
from .engine_factory import build_engine, build_model_engine
from .engine_v2 import InferenceEngineV2
from .scheduler import DynamicSplitFuseScheduler
from .scheduling_utils import SchedulingError, SchedulingResult
