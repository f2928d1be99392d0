"""0/1 Adam (``deepspeed_tpu/runtime/fp16/onebit/zoadam.py``, the reference's
``runtime/fp16/onebit/zoadam.py`` ``ZeroOneAdam``).

The JAX package keeps 0/1 Adam's compression stage: the error-feedback 1-bit
exchange from ``var_freeze_step`` on (which becomes ``freeze_step``), and
reads the local-step schedule's knobs without acting on them. The port does
the same.
"""

from dataclasses import dataclass

from .adam import OnebitAdam


@dataclass
class ZeroOneAdam(OnebitAdam):
    var_freeze_step: int = 100000
    var_update_scaler: int = 16
    local_step_scaler: int = 32678
    local_step_clipper: int = 16

    @classmethod
    def from_params(cls, params: dict):
        base = OnebitAdam.from_params(params)
        base.freeze_step = params.get("var_freeze_step", params.get("freeze_step", 100))
        return cls(**base.__dict__,
                   var_freeze_step=params.get("var_freeze_step", 100000),
                   var_update_scaler=params.get("var_update_scaler", 16),
                   local_step_scaler=params.get("local_step_scaler", 32678),
                   local_step_clipper=params.get("local_step_clipper", 16))
