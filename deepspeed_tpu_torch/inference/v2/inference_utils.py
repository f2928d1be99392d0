"""v2 inference enums and small helpers (counterpart of
``deepspeed_tpu/inference/v2/inference_utils.py``, the reference's
``inference/v2/inference_utils.py``): NormTypeEnum, DtypeEnum (torch
dtypes), ActivationType, is_gated, elem_size, ceil_div."""

from enum import Enum, IntEnum

import torch


class NormTypeEnum(Enum):
    LayerNorm = "layer_norm"
    GroupNorm = "group_norm"
    RMSNorm = "rms_norm"


class DtypeEnum(Enum):
    fp16 = (torch.float16, "torch.float16", "fp16", "float16", "half")
    bf16 = (torch.bfloat16, "torch.bfloat16", "bf16", "bfloat16", "brain floating point")
    fp32 = (torch.float32, "torch.float32", "fp32", "float32", "float")
    int8 = (torch.int8, "torch.int8", "int8")

    @classmethod
    def from_str(cls, value: str) -> "DtypeEnum":
        for member in cls:
            if value in member.value:
                return member
        raise ValueError(f"unknown dtype {value!r}")

    @property
    def dtype(self) -> torch.dtype:
        return self.value[0]


class ActivationType(IntEnum):
    GELU = 0
    RELU = 1
    SILU = 2
    GEGLU = 3
    ReGLU = 4
    SiGLU = 5
    IDENTITY = 6
    InvalidType = -1


def is_gated(act_fn: ActivationType) -> bool:
    return act_fn in (ActivationType.GEGLU, ActivationType.ReGLU, ActivationType.SiGLU)


def elem_size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)
