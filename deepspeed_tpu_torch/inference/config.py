"""Inference config of the v1 engine, without pydantic.

Counterpart of ``deepspeed_tpu/inference/config.py``: ``DeepSpeedInferenceConfig``
and its ``tensor_parallel`` / ``moe`` / ``quant`` blocks, with the same JSON
names and aliases (``tp``, ``kernel_injection``, ``tm``, ``max_out_tokens``,
``replace_method_kernel``, ``injection_dict``, ``num_experts``). Build one
from a JSON dict with :meth:`DeepSpeedInferenceConfig.from_dict`, or with
field names as keywords (blocks may be given as dicts). ``"auto"`` means
the default, as in the JAX package. Unlike it, an unknown key raises, and so
does a setting the port has not ported: ``quant.enabled`` or ``dtype:
"int8"``, a ``checkpoint`` to load. ``tensor_parallel.tp_size`` (alias
``tp``) above 1 serves each rank's shards over the model group.
``enable_cuda_graph`` is accepted and does nothing, as in the JAX package;
so are the kernel-injection knobs, which name no module surgery here either.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..runtime.config_utils import DeepSpeedConfigError, from_dict

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float16": torch.float16,
           "fp16": torch.float16, "half": torch.float16, "float32": torch.float32,
           "fp32": torch.float32}


@dataclass
class DeepSpeedTPConfig:
    """``tensor_parallel`` block: ``tp_size`` ranks split each layer (the
    engine builds ``MeshConfig(data=-1, model=tp_size)`` over the
    initialised process group)."""
    enabled: bool = True
    tp_size: int = 1
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None

    def __post_init__(self):
        if int(self.tp_size) < 1:
            raise DeepSpeedConfigError(f"tensor_parallel.tp_size must be >= 1, got {self.tp_size}")


@dataclass
class DeepSpeedMoEConfig:
    """``moe`` block (descriptive, as in the JAX package: the model's own
    config decides its experts)."""
    enabled: bool = True
    ep_size: int = 1
    moe_experts: list = field(default_factory=lambda: [1])
    type: str = "standard"


@dataclass
class QuantizationConfig:
    """``quant`` block."""
    enabled: bool = False
    num_bits: int = 8

    def __post_init__(self):
        if self.enabled:
            raise NotImplementedError("quant.enabled: int8 / int4 weight-only linears are not "
                                      "ported to the PyTorch package yet (ROADMAP A7)")


_ALIASES = {"kernel_injection": "kernel_inject", "tp": "tensor_parallel",
            "tm": "triangular_masking", "max_out_tokens": "max_tokens",
            "replace_method_kernel": "replace_with_kernel_inject",
            "injection_dict": "injection_policy"}
_BLOCKS = {"tensor_parallel": (DeepSpeedTPConfig, {}),
           "moe": (DeepSpeedMoEConfig, {"num_experts": "moe_experts"}),
           "quant": (QuantizationConfig, {})}


@dataclass
class DeepSpeedInferenceConfig:
    """The JAX package's ``DeepSpeedInferenceConfig`` field surface."""
    kernel_inject: bool = False
    dtype: Any = "bfloat16"
    tensor_parallel: Any = None
    enable_cuda_graph: bool = False  # accepted; does nothing (config.py:40)
    zero: dict = field(default_factory=dict)
    triangular_masking: bool = True
    moe: Any = None
    quant: Any = None
    checkpoint: Optional[str] = None
    base_dir: str = ""
    max_tokens: int = 1024
    min_out_tokens: int = 1
    transposed_mode: bool = False
    replace_with_kernel_inject: bool = False
    injection_policy: Optional[dict] = None
    injection_policy_tuple: Optional[tuple] = None
    replace_method: str = "auto"

    def __post_init__(self):
        for name, (cls, aliases) in _BLOCKS.items():
            value = getattr(self, name)
            if not dataclasses.is_dataclass(value):
                setattr(self, name, from_dict(cls, value or {}, name, aliases))
        if self.checkpoint is not None:
            raise NotImplementedError(f"checkpoint={self.checkpoint!r}: loading an inference "
                                      f"checkpoint is not ported to the PyTorch package yet "
                                      f"(ROADMAP A9)")
        _resolve_dtype(self.dtype)  # refuse int8 and unknown names now, not at first use

    @classmethod
    def from_dict(cls, data) -> "DeepSpeedInferenceConfig":
        """From a JSON dict: aliases renamed, ``"auto"`` values dropped,
        unknown keys refused by name."""
        return from_dict(cls, data, "inference", _ALIASES)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _resolve_dtype(self.dtype)


def _resolve_dtype(value) -> torch.dtype:
    """A dtype name (or ``torch.<name>``) -> the torch dtype."""
    name = str(value).replace("torch.", "")
    if name == "int8":
        raise NotImplementedError("dtype 'int8': int8 / int4 weight-only linears are not ported "
                                  "to the PyTorch package yet (ROADMAP A7)")
    if name not in _DTYPES:
        raise DeepSpeedConfigError(f"inference dtype {value!r} is not one of {sorted(_DTYPES)}")
    return _DTYPES[name]
