"""LR schedules as pure ``step -> lr`` functions of torch ops.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (LRRangeTest /
OneCycle / WarmupLR / WarmupDecayLR / WarmupCosineLR, the same formulas).
``step`` may be a Python number or a tensor; on a device tensor (the
optimizer's update counter) the lr is computed on the device, so the
training step never reads it back to the host. ``LRScheduler`` keeps the
reference's stateful ``step()/get_lr()/state_dict()`` API.
"""

import math
from typing import Callable

import torch

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def lr_range_test_fn(lr_range_test_min_lr=1e-3,
                     lr_range_test_step_size=2000,
                     lr_range_test_step_rate=1.0,
                     lr_range_test_staircase=False,
                     **_) -> Callable:
    """``LRRangeTest``: linearly / staircase-increasing LR probe."""

    def schedule(step):
        interval = _f32(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


def one_cycle_fn(cycle_min_lr=0.0,
                 cycle_max_lr=1e-3,
                 decay_lr_rate=0.0,
                 cycle_first_step_size=2000,
                 cycle_second_step_size=None,
                 cycle_first_stair_count=0,
                 cycle_second_stair_count=None,
                 decay_step_size=0,
                 **_) -> Callable:
    """``OneCycle``: triangular up / down, then decay."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = _f32(step)
        up_frac = torch.clamp(step / cycle_first_step_size, 0.0, 1.0)
        down_frac = torch.clamp((step - cycle_first_step_size) / second, 0.0, 1.0)
        in_cycle_lr = torch.where(step <= cycle_first_step_size,
                                  cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up_frac,
                                  cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down_frac)
        post_steps = torch.clamp_min(step - total_cycle, 0.0)
        decay = post_steps / max(decay_step_size, 1) if decay_step_size > 0 else post_steps
        post_lr = (cycle_min_lr / (1.0 + decay * decay_lr_rate) if decay_lr_rate > 0 else
                   torch.full_like(step, cycle_min_lr))
        return torch.where(step <= total_cycle, in_cycle_lr, post_lr)

    return schedule


def warmup_lr_fn(warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=1000,
                 warmup_type=WARMUP_LOG_RATE, **_) -> Callable:
    """``WarmupLR``: warmup, then hold."""
    warmup_num_steps = max(2, warmup_num_steps)
    inverse_log_warm_up = 1.0 / math.log(warmup_num_steps)

    def schedule(step):
        step = _f32(step)
        if warmup_type == WARMUP_LOG_RATE:
            gamma = inverse_log_warm_up * torch.log(torch.clamp_min(step, 1.0))
        else:
            gamma = step / warmup_num_steps
        gamma = torch.clamp(gamma, 0.0, 1.0)
        return torch.where(step < warmup_num_steps,
                           warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma,
                           torch.full_like(step, warmup_max_lr))

    return schedule


def warmup_decay_lr_fn(total_num_steps,
                       warmup_min_lr=0.0,
                       warmup_max_lr=1e-3,
                       warmup_num_steps=1000,
                       warmup_type=WARMUP_LOG_RATE,
                       **_) -> Callable:
    """``WarmupDecayLR``: warmup, then linear decay to 0."""
    warm = warmup_lr_fn(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    warmup_num_steps_c = max(2, warmup_num_steps)

    def schedule(step):
        step = _f32(step)
        decay = torch.clamp((total_num_steps - step)
                            / max(1.0, total_num_steps - warmup_num_steps_c), 0.0, 1.0)
        return torch.where(step < warmup_num_steps_c, warm(step), warmup_max_lr * decay)

    return schedule


def warmup_cosine_lr_fn(total_num_steps,
                        warmup_min_ratio=0.0,
                        cos_min_ratio=1e-4,
                        warmup_num_steps=1000,
                        warmup_type=WARMUP_LINEAR_RATE,
                        lr=1e-3,
                        **_) -> Callable:
    """``WarmupCosineLR``: ratio-based warmup, then cosine decay."""
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        step = _f32(step)
        if warmup_type == WARMUP_LOG_RATE:
            gamma = torch.log(torch.clamp_min(step, 1.0)) / math.log(warmup_num_steps)
        else:
            gamma = step / warmup_num_steps
        warm_ratio = warmup_min_ratio + (1.0 - warmup_min_ratio) * torch.clamp(gamma, 0.0, 1.0)
        progress = torch.clamp((step - warmup_num_steps)
                               / max(1.0, total_num_steps - warmup_num_steps), 0.0, 1.0)
        cos_ratio = cos_min_ratio + (1.0 - cos_min_ratio) * 0.5 * (1.0 + torch.cos(math.pi
                                                                                  * progress))
        return lr * torch.where(step < warmup_num_steps, warm_ratio, cos_ratio)

    return schedule


SCHEDULE_FNS = {
    LR_RANGE_TEST: lr_range_test_fn,
    ONE_CYCLE: one_cycle_fn,
    WARMUP_LR: warmup_lr_fn,
    WARMUP_DECAY_LR: warmup_decay_lr_fn,
    WARMUP_COSINE_LR: warmup_cosine_lr_fn,
}


def get_lr_schedule_fn(name: str, params: dict, base_lr: float = 1e-3) -> Callable:
    """A pure ``step -> lr`` schedule from a DeepSpeed scheduler block."""
    if name not in SCHEDULE_FNS:
        raise ValueError(f"unknown lr schedule {name}; valid: {VALID_LR_SCHEDULES}")
    params = dict(params)
    if name == WARMUP_COSINE_LR:
        params.setdefault("lr", base_lr)
    return SCHEDULE_FNS[name](**params)


class LRScheduler:
    """Stateful wrapper with the reference scheduler API (``step()``,
    ``get_lr()``, ``get_last_lr()``, ``state_dict()``)."""

    def __init__(self, schedule_fn: Callable, last_batch_iteration: int = -1):
        self.schedule_fn = schedule_fn
        self.last_batch_iteration = last_batch_iteration

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        return self.get_lr()

    def get_lr(self):
        return [float(self.schedule_fn(max(0, self.last_batch_iteration)))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
