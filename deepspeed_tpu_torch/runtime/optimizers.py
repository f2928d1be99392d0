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
optimizers' names map as in the JAX package (``optimizers.py:48,61``):
``onebitadam`` and ``zerooneadam`` to ``Adam``, ``onebitlamb`` to ``Lamb``;
the engine runs their compressed gradient exchange
(``runtime/fp16/onebit``).

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
    ``trust_groups`` makes tensors share one, with the norms over all of
    them (the engine groups a ``TransformerLM``'s per-layer tensors of one
    stacked JAX leaf, so its ratio is the JAX engine's). A group's entry is
    an index into the parameters (the whole tensor) or ``(index, lo, hi)``,
    elements ``[lo, hi)`` of that tensor flattened: the engine's ZeRO
    buffers hold many leaves each, and at stage 1 a shard of them. An
    element in no entry (a buffer's padding) takes the ratio 1.
    ``norm_group``: a process group over which the groups' squared norms
    are summed (one ``all_reduce`` a step), where each rank holds a shard of
    every group."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0,
                 trust_groups=None, norm_group=None):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        n = len(self.flat_params())
        self.trust_groups = ([[i] for i in range(n)] if trust_groups is None else
                             [list(g) for g in trust_groups])
        self.norm_group = norm_group
        whole = [e for g in self.trust_groups for e in g if not isinstance(e, tuple)]
        parts = {e[0] for g in self.trust_groups for e in g if isinstance(e, tuple)}
        if (len(set(whole)) != len(whole) or parts & set(whole)
                or not parts <= set(range(n)) or (not parts and set(whole) != set(range(n)))):
            raise ValueError("trust_groups must hold every parameter index once (whole), or "
                             "(index, lo, hi) slices of them")

    def _update(self, p, g, lr, count_inc):  # -> (new state, the direction before the ratio)
        grp = self.param_groups[0]
        b1, b2 = grp["betas"]
        m_new, v_new, u = _adam_direction(self, p, g, count_inc, b1, b2, grp["eps"])
        return {"mu": m_new, "nu": v_new}, u + grp["weight_decay"] * p

    def _ratios(self, ps, upd):
        """[the trust ratio of each group], and its pieces: (group, tensor
        index, element slice or None)."""
        pieces, p_norms, u_norms = [], [], []
        for gi, group in enumerate(self.trust_groups):
            for e in group:
                i, sl = (e[0], slice(e[1], e[2])) if isinstance(e, tuple) else (e, None)
                if i not in upd:
                    continue
                p, u = ps[i], upd[i][1]
                pieces.append((gi, i, sl))
                p_norms.append(torch.linalg.vector_norm(p if sl is None else p.view(-1)[sl]))
                u_norms.append(torch.linalg.vector_norm(u if sl is None else u.view(-1)[sl]))
        if not pieces and self.norm_group is None:
            return [], pieces
        sq = torch.zeros(len(self.trust_groups), 2, device=ps[0].device)
        if pieces:
            which = torch.tensor([gi for gi, _, _ in pieces], device=sq.device)
            sq.index_add_(0, which, torch.stack([torch.stack(p_norms), torch.stack(u_norms)],
                                                dim=1).square())
        if self.norm_group is not None:
            from .. import comm

            comm.all_reduce(sq, group=self.norm_group)
        norms = sq.sqrt()
        ratio = torch.where((norms[:, 0] == 0) | (norms[:, 1] == 0), torch.ones_like(norms[:, 0]),
                            norms[:, 0] / norms[:, 1])
        return ratio, pieces

    @torch.no_grad()
    def step(self, closure=None, gate: Optional[torch.Tensor] = None):
        loss = closure() if closure is not None else None
        count_inc = self.count + 1
        lr = self.lr_at(self.count)
        ps = self.flat_params()
        upd = {i: self._update(p, p.grad.float(), lr, count_inc)
               for i, p in enumerate(ps) if p.grad is not None}
        ratio, pieces = self._ratios(ps, upd)
        scale = {}  # tensor index -> its ratio (a scalar, or one a flattened element)
        for gi, i, sl in pieces:
            if sl is None:
                scale[i] = ratio[gi]
                continue
            if i not in scale:
                scale[i] = torch.ones(ps[i].numel(), device=ps[i].device)
            scale[i][sl] = ratio[gi]
        for i, (new_state, u) in upd.items():
            p = ps[i]
            for name, val in new_state.items():
                old = self.state[p][name]
                old.copy_(val if gate is None else torch.where(gate, val, old))
            r = scale.get(i, 1.0)
            p_new = p + (-lr) * (u * (r.view_as(p) if torch.is_tensor(r) and r.dim() else r))
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
                    trust_groups=None, norm_group=None) -> torch.optim.Optimizer:
    """The optimizer of a DeepSpeed ``optimizer`` block over ``model_params``
    (``trust_groups``, ``norm_group``: Lamb's, see :class:`Lamb`)."""
    params = dict(params or {})
    name = (name or ADAMW_OPTIMIZER).lower()
    learning_rate = lr if lr is not None else params.get("lr", 1e-3)
    wd = params.get("weight_decay", 0.0)
    if name in (ADAM_OPTIMIZER, FUSED_ADAM_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
                ZERO_ONE_ADAM_OPTIMIZER):
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
    if name in (LAMB_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER):
        return Lamb(model_params, learning_rate, weight_decay=wd, trust_groups=trust_groups,
                    norm_group=norm_group, **_adam_args(params))
    if name == LION_OPTIMIZER:
        betas = params.get("betas", (0.9, 0.99))
        return Lion(model_params, learning_rate, betas=(betas[0], betas[1]), weight_decay=wd)
    raise ValueError(f"Unknown optimizer '{name}'")
