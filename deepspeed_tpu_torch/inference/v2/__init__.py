"""FastGen-style inference v2 for the PyTorch port: ragged continuous
batching over a paged KV cache, served by hand-written CUDA paged-attention
kernels, with sampled decoding and a radix-tree prefix cache (host and disk
tiers under it); models built by family name or loaded from a HuggingFace
checkpoint (``build_hf_engine``)."""

from .checkpoint import build_hf_engine
from .config_v2 import (CacheTelemetryConfig, DSStateManagerConfig, HostTierConfig,
                        ModulesConfig, PrefixCacheConfig, RaggedInferenceEngineConfig,
                        SpeculativeConfig)
from .engine_factory import build_engine, build_model_engine
from .engine_v2 import InferenceEngineV2
from .inference_utils import (ActivationType, DtypeEnum, NormTypeEnum, ceil_div, elem_size,
                              is_gated)
from .sampling import SamplingParams
from .scheduler import DynamicSplitFuseScheduler
from .scheduling_utils import SchedulingError, SchedulingResult
