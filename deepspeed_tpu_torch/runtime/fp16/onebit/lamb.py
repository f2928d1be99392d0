"""1-bit Lamb (``deepspeed_tpu/runtime/fp16/onebit/lamb.py``, the reference's
``runtime/fp16/onebit/lamb.py``): the compressed gradient exchange with
Lamb's trust-ratio update (the port's ``Lamb``, one ratio a JAX leaf)."""

from dataclasses import dataclass

from .adam import OnebitAdam


@dataclass
class OnebitLamb(OnebitAdam):
    max_coeff: float = 10.0
    min_coeff: float = 0.01
    coeff_beta: float = 0.9
    factor_max: float = 4.0
    factor_min: float = 0.5
    factor_threshold: float = 0.1

    base_optimizer = "lamb"

    @classmethod
    def from_params(cls, params: dict):
        base = OnebitAdam.from_params(params)
        return cls(**base.__dict__,
                   max_coeff=params.get("max_coeff", 10.0),
                   min_coeff=params.get("min_coeff", 0.01),
                   coeff_beta=params.get("coeff_beta", 0.9))
