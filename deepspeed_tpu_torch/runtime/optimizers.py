"""Optimizers from DeepSpeed config names, as ``torch.optim`` objects whose
update equals the JAX package's optax chains.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py:38-74``: ``adam`` /
``fusedadam`` (``adam_w_mode``, default True: AdamW; False: L2 decay added
to the gradient before Adam), ``adamw``, ``sgd`` (momentum, nesterov, L2
decay) and ``adagrad``, each with optax's formulas and order of operations
(``scale_by_adam``, ``add_decayed_weights``, ``trace``, ``scale_by_rss``,
``scale_by_learning_rate``). Lamb, Lion and the 1-bit optimizers are not
ported yet and raise.

Every optimizer here keeps optax's global update counter ``count`` (an int32
tensor on the parameters' device) and evaluates an lr schedule on it, and
its :meth:`step` takes an optional ``gate``: a device bool tensor that, when
False, leaves parameters, state and counter as they were (the JAX engine's
overflow ``where``-select), with no host synchronisation.
"""

from typing import Callable, Optional, Union

import torch

from .constants import (ADAGRAD_OPTIMIZER, ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER,
                        LAMB_OPTIMIZER, LION_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
                        SGD_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER)

ScalarOrSchedule = Union[float, Callable]


class _OptaxLike(torch.optim.Optimizer):

    def __init__(self, params, lr: ScalarOrSchedule, defaults: dict):
        super().__init__(params, dict(defaults, lr=lr))
        ps = self.flat_params()
        self.count = torch.zeros((), dtype=torch.int32, device=ps[0].device)

    def flat_params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def lr_at(self, count):
        lr = self.param_groups[0]["lr"]
        return lr(count) if callable(lr) else lr

    def _init_state(self, p, name, fill=0.0):
        st = self.state[p]
        if name not in st:
            st[name] = torch.full_like(p, fill, dtype=torch.float32)
        return st[name]

    def _update(self, p, g, lr, count_inc):  # -> {state name: new value}, new param
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, gate: Optional[torch.Tensor] = None):
        loss = closure() if closure is not None else None
        count_inc = self.count + 1
        lr = self.lr_at(self.count)
        for p in self.flat_params():
            if p.grad is None:
                continue
            new_state, p_new = self._update(p, p.grad.float(), lr, count_inc)
            for name, val in new_state.items():
                old = self.state[p][name]
                old.copy_(val if gate is None else torch.where(gate, val, old))
            p.copy_(p_new if gate is None else torch.where(gate, p_new, p))
        self.count.copy_(count_inc if gate is None else torch.where(gate, count_inc, self.count))
        return loss


class Adam(_OptaxLike):
    """optax ``adamw`` (``adam_w_mode``) or ``chain(add_decayed_weights,
    adam)``: m = (1-b1) g + b1 m, v = (1-b2) g^2 + b2 v, bias corrections
    1 - b^count, u = m_hat / (sqrt(v_hat) + eps) (+ wd p), p += -lr u."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adam_w_mode=True):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                          adam_w_mode=adam_w_mode))

    def _update(self, p, g, lr, count_inc):
        grp = self.param_groups[0]
        b1, b2 = grp["betas"]
        wd = grp["weight_decay"]
        m, v = self._init_state(p, "mu"), self._init_state(p, "nu")
        if wd and not grp["adam_w_mode"]:
            g = g + wd * p
        m_new = (1 - b1) * g + b1 * m
        v_new = (1 - b2) * (g * g) + b2 * v
        t = count_inc.float()
        u = (m_new / (1 - torch.pow(b1, t))) / (torch.sqrt(v_new / (1 - torch.pow(b2, t)) + 0.0)
                                               + grp["eps"])
        if wd and grp["adam_w_mode"]:
            u = u + wd * p
        return {"mu": m_new, "nu": v_new}, p + (-lr) * u


class SGD(_OptaxLike):
    """optax ``sgd`` (``trace`` momentum, optional nesterov), with L2 decay
    added to the gradient first (``chain(add_decayed_weights, sgd)``)."""

    def __init__(self, params, lr=1e-3, momentum=0.0, nesterov=False, weight_decay=0.0):
        super().__init__(params, lr, dict(momentum=momentum, nesterov=nesterov,
                                          weight_decay=weight_decay))

    def _update(self, p, g, lr, count_inc):
        grp = self.param_groups[0]
        if grp["weight_decay"]:
            g = g + grp["weight_decay"] * p
        new_state = {}
        if grp["momentum"] is not None:
            t = self._init_state(p, "trace")
            new_trace = g + grp["momentum"] * t
            new_state["trace"] = new_trace
            g = g + grp["momentum"] * new_trace if grp["nesterov"] else new_trace
        return new_state, p + (-lr) * g


class Adagrad(_OptaxLike):
    """optax ``adagrad``: sum_sq += g^2, u = g * rsqrt(sum_sq + eps) where
    sum_sq > 0, p += -lr u."""

    def __init__(self, params, lr=1e-3, eps=1e-7, initial_accumulator_value=0.1):
        super().__init__(params, lr, dict(eps=eps, initial_accumulator_value=initial_accumulator_value))

    def _update(self, p, g, lr, count_inc):
        grp = self.param_groups[0]
        acc = self._init_state(p, "sum_of_squares", grp["initial_accumulator_value"])
        acc_new = g * g + acc
        inv = torch.where(acc_new > 0, torch.rsqrt(acc_new + grp["eps"]),
                          torch.zeros_like(acc_new))
        return {"sum_of_squares": acc_new}, p + (-lr) * (inv * g)


def _adam_args(params: dict):
    betas = params.get("betas", (0.9, 0.999))
    return dict(betas=(betas[0], betas[1]), eps=params.get("eps", 1e-8))


def build_optimizer(name: Optional[str], model_params, params: Optional[dict] = None,
                    lr: Optional[ScalarOrSchedule] = None) -> torch.optim.Optimizer:
    """The optimizer of a DeepSpeed ``optimizer`` block over ``model_params``."""
    params = dict(params or {})
    name = (name or ADAMW_OPTIMIZER).lower()
    learning_rate = lr if lr is not None else params.get("lr", 1e-3)
    wd = params.get("weight_decay", 0.0)
    if name in (ADAM_OPTIMIZER, FUSED_ADAM_OPTIMIZER):
        return Adam(model_params, learning_rate, weight_decay=wd,
                    adam_w_mode=params.get("adam_w_mode", True), **_adam_args(params))
    if name == ADAMW_OPTIMIZER:
        return Adam(model_params, learning_rate, weight_decay=wd, adam_w_mode=True,
                    **_adam_args(params))
    if name == SGD_OPTIMIZER:
        return SGD(model_params, learning_rate, momentum=params.get("momentum", 0.0),
                   nesterov=params.get("nesterov", False), weight_decay=wd)
    if name == ADAGRAD_OPTIMIZER:
        return Adagrad(model_params, learning_rate, eps=params.get("eps", 1e-10))
    if name in (LAMB_OPTIMIZER, LION_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
                ZERO_ONE_ADAM_OPTIMIZER):
        raise NotImplementedError(f"optimizer '{name}' is not ported to the PyTorch package yet")
    raise ValueError(f"Unknown optimizer '{name}'")
