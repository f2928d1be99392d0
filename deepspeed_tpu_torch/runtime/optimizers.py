"""Optimizers from DeepSpeed config names, as ``torch.optim`` objects whose
update equals the JAX package's optax chains.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py:38-74``: ``adam`` /
``fusedadam`` (``adam_w_mode``, default True: AdamW; False: L2 decay added
to the gradient before Adam), ``adamw``, ``sgd`` (momentum, nesterov, L2
decay), ``adagrad``, ``lamb`` (``optax.lamb``: Adam's direction, decoupled
decay, then the per-tensor trust ratio) and ``lion`` (``optax.lion``), each
with optax 0.2.6's formulas and order of operations (``scale_by_adam``,
``add_decayed_weights``, ``scale_by_trust_ratio``, ``scale_by_lion``,
``trace``, ``scale_by_rss``, ``scale_by_learning_rate``). The 1-bit
optimizers (``onebitadam``, ``zerooneadam``, ``onebitlamb``) raise, naming
ROADMAP A6.7.

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
        if wd and not grp["adam_w_mode"]:
            g = g + wd * p
        m_new, v_new, u = _adam_direction(self, p, g, count_inc, b1, b2, grp["eps"])
        if wd and grp["adam_w_mode"]:
            u = u + wd * p
        return {"mu": m_new, "nu": v_new}, p + (-lr) * u


def _adam_direction(opt, p, g, count_inc, b1, b2, eps):
    """optax ``scale_by_adam`` (eps_root 0): new (mu, nu) and the update."""
    m, v = opt._init_state(p, "mu"), opt._init_state(p, "nu")
    m_new = (1 - b1) * g + b1 * m
    v_new = (1 - b2) * (g * g) + b2 * v
    t = count_inc.float()
    u = (m_new / (1 - torch.pow(b1, t))) / (torch.sqrt(v_new / (1 - torch.pow(b2, t)) + 0.0) + eps)
    return m_new, v_new, u


class Lamb(_OptaxLike):
    """optax ``lamb``: u = Adam's direction (eps_root 0) + wd p, then the
    trust ratio ||p|| / ||u|| (1 where either norm is 0), p += -lr u.

    The ratio is taken over one optax leaf: by default each tensor;
    ``trust_groups`` (lists of indices into the parameters) makes tensors
    share one, with the norms over all of them (the engine groups a
    ``TransformerLM``'s per-layer tensors of one stacked JAX leaf, so its
    ratio is the JAX engine's)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0,
                 trust_groups=None):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        n = len(self.flat_params())
        self.trust_groups = ([[i] for i in range(n)] if trust_groups is None else
                             [list(g) for g in trust_groups])
        if sorted(i for g in self.trust_groups for i in g) != list(range(n)):
            raise ValueError("trust_groups must hold every parameter index once")

    def _update(self, p, g, lr, count_inc):  # -> (new state, the direction before the ratio)
        grp = self.param_groups[0]
        b1, b2 = grp["betas"]
        m_new, v_new, u = _adam_direction(self, p, g, count_inc, b1, b2, grp["eps"])
        return {"mu": m_new, "nu": v_new}, u + grp["weight_decay"] * p

    @torch.no_grad()
    def step(self, closure=None, gate: Optional[torch.Tensor] = None):
        loss = closure() if closure is not None else None
        count_inc = self.count + 1
        lr = self.lr_at(self.count)
        ps = self.flat_params()
        for group in self.trust_groups:
            group = [i for i in group if ps[i].grad is not None]
            if not group:
                continue
            upd = [self._update(ps[i], ps[i].grad.float(), lr, count_inc) for i in group]
            p_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(ps[i]) for i in group]))
            u_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(u) for _, u in upd]))
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            for i, (new_state, u) in zip(group, upd):
                p = ps[i]
                for name, val in new_state.items():
                    old = self.state[p][name]
                    old.copy_(val if gate is None else torch.where(gate, val, old))
                p_new = p + (-lr) * (u * ratio)
                p.copy_(p_new if gate is None else torch.where(gate, p_new, p))
        self.count.copy_(count_inc if gate is None else torch.where(gate, count_inc, self.count))
        return loss


class Lion(_OptaxLike):
    """optax ``lion``: u = sign((1-b1) g + b1 m), m = (1-b2) g + b2 m, then
    u + wd p, p += -lr u."""

    def __init__(self, params, lr=1e-4, betas=(0.9, 0.99), weight_decay=1e-3):
        super().__init__(params, lr, dict(betas=tuple(betas), weight_decay=weight_decay))

    def _update(self, p, g, lr, count_inc):
        grp = self.param_groups[0]
        b1, b2 = grp["betas"]
        m = self._init_state(p, "mu")
        u = torch.sign((1.0 - b1) * g + b1 * m)
        m_new = (1 - b2) * g + b2 * m
        u = u + grp["weight_decay"] * p
        return {"mu": m_new}, p + (-lr) * u


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
                    lr: Optional[ScalarOrSchedule] = None,
                    trust_groups=None) -> torch.optim.Optimizer:
    """The optimizer of a DeepSpeed ``optimizer`` block over ``model_params``
    (``trust_groups``: Lamb's, see :class:`Lamb`)."""
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
    if name == LAMB_OPTIMIZER:
        return Lamb(model_params, learning_rate, weight_decay=wd, trust_groups=trust_groups,
                    **_adam_args(params))
    if name == LION_OPTIMIZER:
        betas = params.get("betas", (0.9, 0.99))
        return Lion(model_params, learning_rate, betas=(betas[0], betas[1]), weight_decay=wd)
    if name in (ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER):
        raise NotImplementedError(f"optimizer '{name}' (a 1-bit optimizer) is not ported to the "
                                  f"PyTorch package yet (ROADMAP A6.7)")
    raise ValueError(f"Unknown optimizer '{name}'")
