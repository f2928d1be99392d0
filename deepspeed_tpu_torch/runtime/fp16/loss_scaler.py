"""Loss scaling (a copy of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``:
``LossScaler``/``DynamicLossScaler``).

The engine keeps the scale as a device tensor and advances it with device
ops (``engine._advance_loss_scale``); these classes are the standalone
host-side API for code that drives scaling manually: on overflow halve (not
below ``min_scale``) and reset the window; after ``scale_window`` good steps
double.
"""

import numpy as np

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
CONSECUTIVE_HYSTERESIS = "consecutive_hysteresis"
MIN_LOSS_SCALE = "min_scale"


class LossScalerBase:

    def __init__(self, cur_scale):
        self.cur_scale = float(cur_scale)
        self.dynamic = False

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, module, grad_in, grad_out):
        return tuple(self.loss_scale * g for g in grad_in)

    def update_scale(self, overflow):
        pass

    def backward(self, loss, retain_graph=False):
        return loss * self.loss_scale


class LossScaler(LossScalerBase):
    """Static loss scale (reference ``LossScaler``)."""

    def __init__(self, scale=1.0):
        super().__init__(scale)

    def has_overflow(self, params):
        return False


class DynamicLossScaler(LossScalerBase):
    """Dynamic loss scale with hysteresis (reference ``DynamicLossScaler``)."""

    def __init__(self,
                 init_scale=2**32,
                 scale_factor=2.0,
                 scale_window=1000,
                 min_scale=1.0,
                 delayed_shift=1,
                 consecutive_hysteresis=False,
                 raise_error_at_min_scale=True,
                 dtype=np.float16):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis
        self.raise_error_at_min_scale = raise_error_at_min_scale
        self.dynamic = True
        self.dtype = dtype

    def has_overflow_serial(self, grads):
        for g in grads:
            a = np.asarray(g)
            if not np.isfinite(a).all():
                return True
        return False

    has_overflow = has_overflow_serial

    def update_scale(self, overflow):
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                if self.cur_scale == self.min_scale and self.raise_error_at_min_scale:
                    raise Exception("Current loss scale already at minimum - cannot decrease scale anymore.")
                self.cur_scale = max(self.cur_scale / self.scale_factor, self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) % self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1


def CreateLossScaler(dtype, static_loss_scale, dynamic_scaling, dynamic_loss_args):
    """Reference factory of the same name."""
    if dtype == np.float16 and dynamic_scaling:
        return DynamicLossScaler(dtype=dtype, **(dynamic_loss_args or {}))
    return LossScaler(scale=static_loss_scale if dtype == np.float16 else 1.0)
