"""ZeRO configuration (``zero_optimization``), without pydantic.

Counterpart of ``deepspeed_tpu/runtime/zero/config.py``: the same field
names, so the same JSON block parses. ``stage`` (0-3) picks what
``runtime/zero/partition.py`` shards over the data-parallel ranks (at
world size 1 every stage is the same single-rank step). The bucket, overlap,
prefetch and persistence knobs (``reduce_bucket_size``,
``allgather_bucket_size``, ``overlap_comm``, ``contiguous_gradients``,
``prefetch_bucket_size``, ``param_persistence_threshold``,
``max_live_parameters``, ...) are accepted and unused: the partition
reduces and gathers one whole group (a transformer block) at a time, in the
compute stream. What is not ported raises and names its key: offload
(``offload_param``, ``offload_optimizer``, ``cpu_offload*``), ZeRO++
(``zero_quantized_*``, ``zero_hpz_partition_size`` > 1) and MiCS
(``mics_shard_size`` > 0).
"""

from dataclasses import dataclass
from typing import Any, Optional

from ..config_utils import DeepSpeedConfigError, from_dict

_ALIASES = {
    "stage3_prefetch_bucket_size": "prefetch_bucket_size",
    "stage3_param_persistence_threshold": "param_persistence_threshold",
    "stage3_model_persistence_threshold": "model_persistence_threshold",
    "stage3_max_live_parameters": "max_live_parameters",
    "stage3_max_reuse_distance": "max_reuse_distance",
    "stage3_gather_16bit_weights_on_model_save": "gather_16bit_weights_on_model_save",
}


@dataclass
class DeepSpeedZeroConfig:
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    use_multi_rank_bucket_allreduce: bool = True
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[Any] = None
    offload_optimizer: Optional[Any] = None
    sub_group_size: int = int(1e9)
    cpu_offload_param: Optional[bool] = None
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = None
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    model_persistence_threshold: int = int(1e14)
    max_live_parameters: int = int(1e9)
    max_reuse_distance: int = int(1e9)
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    zero_quantized_weights: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_gradients: bool = False
    zero_quantized_nontrainable_weights: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True

    def __post_init__(self):
        if isinstance(self.stage, bool) or not isinstance(self.stage, int) \
                or not 0 <= self.stage <= 3:
            raise DeepSpeedConfigError(f"zero_optimization.stage must be 0, 1, 2 or 3, got "
                                       f"{self.stage!r}")
        for key in ("offload_param", "offload_optimizer"):
            block = getattr(self, key)
            if block is not None and (not isinstance(block, dict)
                                      or str(block.get("device", "none")) != "none"):
                raise NotImplementedError(f"zero_optimization.{key} (offload) is not ported to "
                                          f"the PyTorch package yet")
        for key in ("cpu_offload", "cpu_offload_param", "zero_quantized_weights",
                    "zero_quantized_gradients", "zero_quantized_nontrainable_weights"):
            if getattr(self, key):
                raise NotImplementedError(f"zero_optimization.{key} is not ported to the "
                                          f"PyTorch package yet")
        if self.zero_hpz_partition_size > 1:
            raise NotImplementedError("zero_optimization.zero_hpz_partition_size (ZeRO++ hpZ) "
                                      "is not ported to the PyTorch package yet")
        if self.mics_shard_size > 0:
            raise NotImplementedError("zero_optimization.mics_shard_size (MiCS) is not ported "
                                      "to the PyTorch package yet")
        if self.overlap_comm is None:
            self.overlap_comm = self.stage == 3

    @classmethod
    def from_dict(cls, data) -> "DeepSpeedZeroConfig":
        return from_dict(cls, data, "zero_optimization", _ALIASES)
