"""DeepSpeed JSON config for the PyTorch port, without pydantic.

Counterpart of ``deepspeed_tpu/runtime/config.py`` for the keys the
training slice uses: the batch triad and its resolution
(``train_batch = micro_batch x gas x dp_world``), ``optimizer``,
``scheduler``, ``fp16`` (with the dynamic loss-scale arguments), ``bf16``,
``gradient_clipping``, ``zero_optimization``, ``steps_per_print``,
``dataloader_drop_last``, ``tpu.pallas_fused_adam``, ``sparse_attention``
(kept raw, as the JAX package keeps it), ``sparse_gradients`` (a logged
no-op), ``hybrid_engine`` and ``activation_checkpointing`` (read by
``checkpointing.configure``). The port accepts the same JSON; a key for
something not ported raises and names the key.
"""

import copy
import json
import os
from dataclasses import dataclass, fields
from typing import Optional, Union

from ..parallel.mesh import MeshConfig, refuse_unported_axes
from .config_utils import DeepSpeedConfigError, dict_raise_error_on_duplicate_keys, from_dict
from .constants import (ACTIVATION_CHECKPOINTING, BFLOAT16, BFLOAT16_OLD, DATALOADER_DROP_LAST, DATALOADER_DROP_LAST_DEFAULT,
                        FP16, GRADIENT_ACCUMULATION_STEPS, GRADIENT_CLIPPING,
                        GRADIENT_CLIPPING_DEFAULT, HYBRID_ENGINE, OPTIMIZER, OPTIMIZER_PARAMS,
                        SCHEDULER, SCHEDULER_PARAMS, SPARSE_ATTENTION, SPARSE_GRADIENTS,
                        SPARSE_GRADIENTS_DEFAULT, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT, TPU,
                        TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU, TYPE, ZERO_OPTIMIZATION)
from .zero.config import DeepSpeedZeroConfig

__all__ = ["DeepSpeedConfig", "DeepSpeedConfigError"]

_SUPPORTED_KEYS = {TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU, GRADIENT_ACCUMULATION_STEPS,
                   OPTIMIZER, SCHEDULER, FP16, BFLOAT16, BFLOAT16_OLD, GRADIENT_CLIPPING,
                   ZERO_OPTIMIZATION, STEPS_PER_PRINT, DATALOADER_DROP_LAST, TPU, SPARSE_ATTENTION,
                   SPARSE_GRADIENTS, HYBRID_ENGINE, ACTIVATION_CHECKPOINTING}


@dataclass
class FP16Config:
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False

    def __post_init__(self):
        for key in ("auto_cast", "fp16_master_weights_and_grads"):
            if getattr(self, key):
                raise NotImplementedError(f"fp16.{key} is not ported to the PyTorch package yet")


@dataclass
class BF16Config:
    enabled: bool = False
    immediate_grad_update: bool = False


@dataclass
class ActivationCheckpointingConfig:
    """The ``activation_checkpointing`` block, with the JAX package's fields
    and defaults (``deepspeed_tpu/runtime/config.py:75-90``), which
    ``checkpointing.configure(deepspeed_config=...)`` reads.
    ``remat_policy`` names a policy of ``checkpointing.resolve_policy``.
    ``partition_activations`` spreads saved activations over the ``seq``
    and ``model`` axes in the reference. The port refuses ``seq`` above 1
    (``parallel/mesh.py``); at ``model`` above 1 each rank keeps the whole
    of what a checkpointed block saves (its input, replicated over the
    model group), the flag a no-op: spreading it over the model group is
    ROADMAP A3b, left open.
    ``cpu_checkpointing`` keeps a checkpointed region's inputs in pinned
    host memory."""
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    remat_policy: str = "nothing_saveable"

    def __post_init__(self):
        from .activation_checkpointing.checkpointing import resolve_policy

        resolve_policy(self.remat_policy)  # an unknown name raises, naming it


@dataclass
class TPUConfig:
    """The ``tpu`` block: of its knobs the port honours ``pallas_fused_adam``
    (``"always"`` engages the fused Adam kernel; ``"auto"`` resolves to off,
    as in the JAX package) and ``mesh`` (``parallel.mesh.MeshConfig``'s
    fields; ``data`` and ``model`` may be above 1, one of them -1 for the
    rest of the world; every other axis above 1 raises, naming its ROADMAP
    item)."""
    pallas_fused_adam: str = "auto"
    mesh: dict = None

    def __post_init__(self):
        if self.pallas_fused_adam not in ("auto", "always", "never"):
            raise DeepSpeedConfigError(f"tpu.pallas_fused_adam must be 'auto', 'always' or "
                                       f"'never', got {self.pallas_fused_adam!r}")
        unknown = sorted(set(self.mesh or {}) - {f.name for f in fields(MeshConfig)})
        if unknown:
            raise DeepSpeedConfigError(f"tpu.mesh: unknown axes {unknown}")
        refuse_unported_axes(self.mesh or {})

    def mesh_config(self) -> MeshConfig:
        return MeshConfig(**(self.mesh or {}))


@dataclass
class HybridEngineConfig:
    """The ``hybrid_engine`` block (``deepspeed_tpu/runtime/config.py:233``):
    ``enabled`` makes ``initialize`` return ``DeepSpeedHybridEngine``. The
    other knobs are accepted as the JAX package accepts them. A
    tensor-parallel inference view (``inference_tp_size`` above 1) needs the
    hybrid engine at world size >= 2, which is not ported (ROADMAP A1, left
    open)."""
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8

    def __post_init__(self):
        if int(self.inference_tp_size) > 1:
            raise NotImplementedError(
                f"hybrid_engine.inference_tp_size={self.inference_tp_size}: a tensor-parallel "
                f"inference view needs the hybrid engine at world size >= 2, whose bf16 view of "
                f"sharded masters needs a gather (ROADMAP A1, left open)")


class DeepSpeedConfig:
    """Typed view over the JSON config (``deepspeed_tpu/runtime/config.py``
    :257), for the keys the port supports."""

    def __init__(self, config: Union[str, dict]):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"Expected a string path to an existing deepspeed "
                                           f"config, got: {config}")
            with open(config, "r") as f:
                self._param_dict = json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = copy.deepcopy(config)
        else:
            raise DeepSpeedConfigError(
                f"Expected a string path to a json file or a dict, got: {config} ({type(config)})")
        pd = self._param_dict
        unported = sorted(set(pd) - _SUPPORTED_KEYS)
        if unported:
            raise NotImplementedError(f"ds_config key(s) {unported} are not ported to the PyTorch "
                                      f"package yet (supported: {sorted(_SUPPORTED_KEYS)})")

        # --- precision ---
        self.fp16_config = from_dict(FP16Config, pd.get(FP16, {}), FP16)
        bf16_key = BFLOAT16 if BFLOAT16 in pd else BFLOAT16_OLD
        self.bfloat16_config = from_dict(BF16Config, pd.get(bf16_key, {}), bf16_key)
        self.fp16_enabled = self.fp16_config.enabled
        self.bfloat16_enabled = self.bfloat16_config.enabled
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 modes cannot be simultaneously enabled")
        self.loss_scale = self.fp16_config.loss_scale
        self.initial_dynamic_scale = 2**self.fp16_config.initial_scale_power
        self.dynamic_loss_scale_args = {
            "init_scale": 2**self.fp16_config.initial_scale_power,
            "scale_window": self.fp16_config.loss_scale_window,
            "min_scale": self.fp16_config.min_loss_scale,
            "delayed_shift": self.fp16_config.hysteresis,
        }

        # --- optimizer / scheduler ---
        opt_dict = pd.get(OPTIMIZER, None)
        self.optimizer_name = (opt_dict[TYPE].lower() if opt_dict and TYPE in opt_dict else None)
        self.optimizer_params = opt_dict.get(OPTIMIZER_PARAMS, {}) if opt_dict else None
        for key in (opt_dict or {}):
            if key not in (TYPE, OPTIMIZER_PARAMS):
                raise NotImplementedError(f"ds_config key 'optimizer.{key}' is not ported to the "
                                          f"PyTorch package yet")
        sched_dict = pd.get(SCHEDULER, None)
        self.scheduler_name = sched_dict[TYPE] if sched_dict and TYPE in sched_dict else None
        self.scheduler_params = sched_dict.get(SCHEDULER_PARAMS, {}) if sched_dict else None

        # --- zero ---
        self.zero_config = DeepSpeedZeroConfig.from_dict(pd.get(ZERO_OPTIMIZATION, {}))
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        # --- training knobs ---
        self.gradient_clipping = pd.get(GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT)
        self.steps_per_print = pd.get(STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)
        self.dataloader_drop_last = pd.get(DATALOADER_DROP_LAST, DATALOADER_DROP_LAST_DEFAULT)
        self.tpu_config = from_dict(TPUConfig, pd.get(TPU, {}), TPU)
        self.sparse_gradients_enabled = pd.get(SPARSE_GRADIENTS, SPARSE_GRADIENTS_DEFAULT)
        # the raw block (config.py:313-316): the model takes it through
        # TransformerConfig.sparse_attention, build_sparsity_config validates it
        self.sparse_attention = pd.get(SPARSE_ATTENTION)
        self.hybrid_engine_config = from_dict(HybridEngineConfig, pd.get(HYBRID_ENGINE, {}),
                                              HYBRID_ENGINE)
        self.activation_checkpointing_config = from_dict(
            ActivationCheckpointingConfig, pd.get(ACTIVATION_CHECKPOINTING, {}),
            ACTIVATION_CHECKPOINTING)

        # --- batch triad (resolved against the data-parallel size later) ---
        self.train_batch_size = pd.get(TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(GRADIENT_ACCUMULATION_STEPS)
        self._batch_resolved = False

    def resolve_batch_config(self, dp_world_size: int):
        """Fill in the missing leg of train = micro x gas x dp and validate
        (``deepspeed_tpu/runtime/config.py:382``)."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps

        if all(v is not None for v in (train, micro, gas)):
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp_world_size)
        elif train is not None and gas is not None:
            micro = train // (dp_world_size * gas)
        elif micro is not None:
            gas = gas or 1
            train = micro * gas * dp_world_size
        elif train is not None:
            gas = 1
            micro = train // dp_world_size
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
        self._batch_assertion(dp_world_size)
        self._batch_resolved = True

    def _batch_assertion(self, dp_world_size):
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        assert train > 0, f"Train batch size: {train} has to be greater than 0"
        assert micro > 0, f"Micro batch size per gpu: {micro} has to be greater than 0"
        assert gas > 0, f"Gradient accumulation steps: {gas} has to be greater than 0"
        assert train == micro * gas * dp_world_size, (
            f"Check batch related parameters. train_batch_size is not equal "
            f"to micro_batch_per_gpu * gradient_acc_step * world_size "
            f"{train} != {micro} * {gas} * {dp_world_size}")

    @property
    def param_dict(self):
        return self._param_dict
