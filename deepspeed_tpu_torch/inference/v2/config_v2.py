"""Inference v2 configuration (copy of
``deepspeed_tpu/inference/v2/config_v2.py`` with torch dtypes).

The prefix-cache and speculative blocks keep their fields so that configs
written for the TPU package parse; this slice of the port does not serve
them, and the engine refuses a config that enables either.
"""

from dataclasses import dataclass, field
from typing import Union

import torch


@dataclass
class DSStateManagerConfig:
    max_tracked_sequences: int = 128
    max_ragged_batch_size: int = 768
    max_ragged_sequence_count: int = 64
    max_context: int = 2048  # per-sequence context ceiling (blocks * block_size)
    memory_config: str = "auto"  # 'auto' sizes the KV pool from free device memory
    offload: bool = False


@dataclass
class CacheTelemetryConfig:
    """``ragged.prefix_cache.telemetry`` block (not served by this slice)."""
    enabled: bool = False
    mrc_sample_rate: float = 0.25
    mrc_max_tracked: int = 4096
    mrc_capacity_mults: tuple = (0.5, 1.0, 2.0, 4.0, 8.0)


@dataclass
class HostTierConfig:
    """``ragged.prefix_cache.host_tier`` block (not served by this slice)."""
    enabled: bool = True
    host_blocks: int = 0
    host_pool_bytes: int = 0
    low_watermark: float = 0.10
    high_watermark: float = 0.25
    queue_depth: int = 8
    disk_path: object = None
    disk_blocks: int = 256


@dataclass
class PrefixCacheConfig:
    """``ragged.prefix_cache`` block: block-granular KV reuse across
    requests. Not served by this slice: enabling it raises."""
    enabled: bool = False
    eviction: str = "lru"
    min_hit_blocks: int = 1
    telemetry: CacheTelemetryConfig = field(default_factory=CacheTelemetryConfig)
    host_tier: object = None  # Optional[HostTierConfig]


@dataclass
class SpeculativeConfig:
    """``ragged.speculative`` block. Not served by this slice: any mode
    other than 'off' raises."""
    mode: str = "off"  # 'off' | 'ngram' | 'draft_model'
    k: int = 4
    tree_width: int = 1
    backoff_after: int = 8
    reprobe_every: int = 32
    min_match: int = 2
    max_ngram: int = 4
    max_history: int = 256
    draft_engine: object = None

    @property
    def enabled(self) -> bool:
        return self.mode != "off"


@dataclass
class ModulesConfig:
    """Per-op implementation selection: each slot is ``"auto"``, a
    registered implementation name, or ``{"name": ...,
    "implementation_config": {...}}``. Attention ``"auto"`` takes the CUDA
    kernels when the engine runs on CUDA; ``"dense_blocked_attention"``
    asks for the plain version explicitly."""
    attention: object = "auto"
    linear: object = "auto"
    embedding: object = "auto"
    unembed: object = "auto"
    norm: object = "auto"


@dataclass
class RaggedInferenceEngineConfig:
    tensor_parallel_degree: int = 1
    kv_block_size: int = 64
    # pool size in blocks; 0/'auto' sizes the pool from the device's free
    # memory after params (kv_memory_fraction below)
    num_kv_blocks: object = "auto"
    kv_dtype: object = torch.bfloat16  # torch.bfloat16 | torch.int8 | "int8"
    kv_memory_fraction: float = 0.8
    state_manager: DSStateManagerConfig = field(default_factory=DSStateManagerConfig)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)
    quantize_weights: Union[bool, int] = False
    modules: ModulesConfig = field(default_factory=ModulesConfig)
