"""Mixture-of-experts gating and the MoE layer (top-1 / top-2 routing with
capacity), for PyTorch.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` with its formulas kept:
capacity factor and floor, the load-balancing aux loss ``l_aux``, random
token priority (top-1), Gumbel sampling of the second expert (top-2),
token dropping at capacity, dispatch and combine as one-hot einsums. Every
shape is static: the capacity is a Python int and dropped tokens carry zero
weight, so nothing is read back to the host.

Randomness: where the TPU package takes a ``jax.random`` key, these take a
``torch.Generator`` (on the tensors' device) and draw from it in the same
places and order; with ``generator=None`` nothing is drawn and the routing
equals the TPU package's ``rng=None`` routing exactly. The sampled draws
cannot equal threefry's bits; they follow the same distributions.

Expert parallelism (``MOELayer(ep_size > 1, group=...)``, reference
``sharded_moe.py:281-293``): each rank of ``group`` holds ``E / ep_size``
experts, and the dispatched capacity slots go to their experts' owner and
back by :func:`all_to_all` (an autograd Function whose backward is the
same exchange of the gradient, the reference's ``_AllToAll``). The grouped
path does not compose with it, as in the reference.
"""

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .. import comm
from .grouped import grouped_moe_ffn

# exchanges issued by all_to_all (forward and backward), since the last reset
launch_counts = {"all_to_all": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    comm.all_to_all_single(out, x, group=group)
    launch_counts["all_to_all"] += 1
    return out


class _AllToAll(torch.autograd.Function):
    """Dim 0 of ``x`` in ``world`` equal chunks, chunk j to rank j of
    ``group``; the result holds the chunks received, in rank order. The
    exchange is its own inverse, so the backward exchanges the gradient."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, dy):
        return None, _exchange(dy, ctx.group)


def all_to_all(x, group=None):
    """Differentiable ``all_to_all_single`` over ``group`` (None: the
    default process group)."""
    return _AllToAll.apply(group, x)


def multiplicative_jitter(x, generator, epsilon=1e-2):
    """``x`` times uniform noise in [1 - epsilon, 1 + epsilon)."""
    if epsilon == 0:
        return x
    noise = torch.empty_like(x).uniform_(1.0 - epsilon, 1.0 + epsilon, generator=generator)
    return x * noise


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int) -> int:
    """Tokens per expert buffer (static)."""
    return max(math.ceil(num_tokens / num_experts * capacity_factor), min_capacity)


def _one_hot(indices, num_classes, dtype=torch.float32):
    """``jax.nn.one_hot``: an out-of-range index gives a row of zeros."""
    classes = torch.arange(num_classes, device=indices.device)
    return (indices.long()[..., None] == classes).to(dtype)


def _gumbel(like, generator):
    """Standard Gumbel noise shaped like ``like`` (``jax.random.gumbel``:
    ``-log(-log(u))``, u uniform in [tiny, 1))."""
    tiny = torch.finfo(like.dtype).tiny
    u = torch.rand(like.shape, dtype=like.dtype, device=like.device, generator=generator)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def top1gating(logits, capacity_factor: float, min_capacity: int, used_token=None,
               noisy_gate_policy: Optional[str] = None, generator=None, drop_tokens: bool = True,
               use_rts: bool = True):
    """logits [S, E] -> (l_aux, combine [S, E, C], dispatch [S, E, C], C)."""
    S, E = logits.shape
    capacity = _capacity(S, E, capacity_factor, min_capacity)
    if noisy_gate_policy == "RSample" and generator is not None:
        indices1 = torch.argmax(logits + _gumbel(logits, generator), dim=1)
    else:
        indices1 = torch.argmax(logits, dim=1)
    gates = torch.softmax(logits, dim=1)
    mask1 = _one_hot(indices1, E)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None]

    # load-balancing aux loss: me * ce * E
    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    l_aux = (me * ce).sum() * E

    # random token priority: random scores decide which tokens win slots
    if use_rts and generator is not None:
        mask1_rand = mask1 * torch.rand(mask1.shape, dtype=mask1.dtype, device=mask1.device,
                                        generator=generator)
    else:
        mask1_rand = mask1

    if drop_tokens:
        # a token's rank among its expert's tokens (by priority, stable) is
        # its slot; ranks >= capacity drop
        order = torch.argsort(-mask1_rand, dim=0, stable=True)
        ranks = torch.argsort(order, dim=0, stable=True)
        mask1 = torch.where((ranks < capacity) & (mask1 > 0), mask1, torch.zeros_like(mask1))
        locations1_s = (ranks * mask1).sum(dim=1)
    else:
        locations1 = torch.cumsum(mask1, dim=0) - 1
        locations1_s = (locations1 * mask1).sum(dim=1)
        capacity = S  # no dropping: every token gets a slot

    gates1_s = (gates * mask1).sum(dim=1)
    loc_oh = _one_hot(locations1_s, capacity)
    combine = gates1_s[:, None, None] * mask1[:, :, None] * loc_oh[:, None, :]
    dispatch = (combine > 0).to(logits.dtype)
    return l_aux, combine, dispatch, capacity


def top2gating(logits, capacity_factor: float, min_capacity: int, drop_tokens: bool = True,
               top2_2nd_expert_sampling: bool = True, generator=None):
    """logits [S, E] -> (l_aux, combine [S, E, C], dispatch [S, E, C], C)."""
    S, E = logits.shape
    gates = torch.softmax(logits, dim=1)
    capacity = _capacity(S, E, capacity_factor * 2, min_capacity) if drop_tokens else S

    indices1 = torch.argmax(gates, dim=1)
    mask1 = _one_hot(indices1, E)
    if top2_2nd_expert_sampling and generator is not None:
        logits2 = logits + _gumbel(logits, generator)
    else:
        logits2 = logits
    logits_except1 = torch.where(mask1 > 0, torch.full_like(logits2, -math.inf), logits2)
    indices2 = torch.argmax(logits_except1, dim=1)
    mask2 = _one_hot(indices2, E)

    # slots: the first experts' tokens first, the second experts' after
    locations1 = torch.cumsum(mask1, dim=0) - 1
    locations2 = torch.cumsum(mask2, dim=0) - 1 + mask1.sum(dim=0, keepdim=True)

    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    l_aux = (me * ce).mean() * E * E

    if drop_tokens:
        mask1 = mask1 * (locations1 < capacity)
        mask2 = mask2 * (locations2 < capacity)

    locations1_s = (locations1 * mask1).sum(dim=1)
    locations2_s = (locations2 * mask2).sum(dim=1)

    # normalise the kept gate values
    gates1_s = (gates * mask1).sum(dim=1)
    gates2_s = (gates * mask2).sum(dim=1)
    denom = torch.clamp(gates1_s + gates2_s, min=1e-9)
    gates1_s = gates1_s / denom
    gates2_s = gates2_s / denom

    loc1_oh = _one_hot(locations1_s, capacity)
    loc2_oh = _one_hot(locations2_s, capacity)
    combine = (gates1_s[:, None, None] * mask1[:, :, None] * loc1_oh[:, None, :]
               + gates2_s[:, None, None] * mask2[:, :, None] * loc2_oh[:, None, :])
    dispatch = (combine > 0).to(logits.dtype)
    return l_aux, combine, dispatch, capacity


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class TopKGate:
    """Linear gate + top-k routing. ``init(generator)`` makes ``{"wg":
    [model_dim, num_experts]}``; ``__call__(params, x, generator=None,
    train=True)`` routes x [S, M]."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 8,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_rts: bool = True, top2_2nd_expert_sampling: bool = True):
        if k not in (1, 2):
            raise ValueError("only top-1 and top-2 gating are supported")
        self.model_dim = model_dim
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.use_rts = use_rts
        self.top2_2nd_expert_sampling = top2_2nd_expert_sampling

    def init(self, generator, device=None):
        w = torch.randn((self.model_dim, self.num_experts), generator=generator, device=device)
        return {"wg": w / math.sqrt(self.model_dim)}

    def __call__(self, params, x, generator=None, train=True):
        """(l_aux, combine [S, E, C], dispatch [S, E, C], C)."""
        inp = x.float()
        if self.noisy_gate_policy == "Jitter" and generator is not None and train:
            inp = multiplicative_jitter(inp, generator)
        logits = inp @ params["wg"].float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1gating(logits, cf, self.min_capacity,
                              noisy_gate_policy=self.noisy_gate_policy if train else None,
                              generator=generator, drop_tokens=self.drop_tokens,
                              use_rts=self.use_rts and train)
        return top2gating(logits, cf, self.min_capacity, drop_tokens=self.drop_tokens,
                          top2_2nd_expert_sampling=self.top2_2nd_expert_sampling and train,
                          generator=generator)


class MOELayer:
    """Dispatch -> expert FFN -> combine. ``init(generator)`` makes the gate
    and stacked expert weights ``{"wi": [E, M, F], "wo": [E, F, M]}``;
    ``__call__(params, x, ...)`` returns (y [S, M], l_aux). ``moe_impl``:
    ``"einsum"`` (the one-hot ``[S, E, C]`` dispatch and combine) or
    ``"grouped"`` (the expert-sorted grouped matmul, ``moe/grouped.py``;
    the same kept set and gate weights). ``ep_size > 1``: the experts are
    split over the ``ep_size`` ranks of ``group`` (None: the default
    process group), ``num_local_experts`` a rank, and ``__call__`` takes
    this rank's tokens and its experts' weights."""

    def __init__(self, gate: TopKGate, hidden_dim: int, ffn_dim: int, num_local_experts: int,
                 ep_size: int = 1, activation: Callable = gelu, moe_impl: str = "einsum",
                 group=None):
        if moe_impl not in ("einsum", "grouped"):
            raise ValueError(f"moe_impl must be 'einsum' or 'grouped', got {moe_impl!r}")
        if ep_size > 1:
            if moe_impl == "grouped":
                # the exchange moves fixed-capacity slots, which the grouped
                # path does not make (sharded_moe.py:225-233)
                raise NotImplementedError(
                    "moe_impl='grouped' does not compose with expert parallelism yet (the "
                    "all-to-all exchanges fixed-capacity slots); use moe_impl='einsum' for "
                    "EP-sharded layers")
            if comm.get_world_size(group) != ep_size:
                raise ValueError(f"ep_size {ep_size} must equal the size of the expert group, "
                                 f"{comm.get_world_size(group)}")
            if num_local_experts * ep_size != gate.num_experts:
                raise ValueError(f"{num_local_experts} local experts x ep_size {ep_size} != "
                                 f"the gate's {gate.num_experts} experts")
        self.group = group
        self.gate = gate
        self.hidden_dim = hidden_dim
        self.ffn_dim = ffn_dim
        self.num_local_experts = num_local_experts
        self.ep_size = ep_size
        self.activation = activation
        self.moe_impl = moe_impl

    def init(self, generator, device=None):
        E, M, Fd = self.num_local_experts, self.hidden_dim, self.ffn_dim
        gate = self.gate.init(generator, device)
        wi = torch.randn((E, M, Fd), generator=generator, device=device) / math.sqrt(M)
        wo = torch.randn((E, Fd, M), generator=generator, device=device) / math.sqrt(Fd)
        return {"gate": gate, "experts": {"wi": wi, "wo": wo}}

    def _expert_ffn(self, eparams, x):
        """x [E, n, C, M] -> the per-expert FFN as batched einsums."""
        h = torch.einsum("encm,emf->encf", x, eparams["wi"].to(x.dtype))
        return torch.einsum("encf,efm->encm", self.activation(h), eparams["wo"].to(x.dtype))

    def __call__(self, params, x, generator=None, train=True):
        S, M = x.shape
        E = self.gate.num_experts
        l_aux, combine, dispatch, capacity = self.gate(params["gate"], x, generator=generator,
                                                       train=train)
        if self.moe_impl == "grouped":
            y = grouped_moe_ffn(x, combine.sum(dim=2), params["experts"]["wi"],
                                params["experts"]["wo"], top_k=self.gate.k,
                                activation=lambda up, gate: self.activation(up))
            return y, l_aux
        dispatched = torch.einsum("sec,sm->ecm", dispatch.to(x.dtype), x)
        if self.ep_size > 1:
            # [ep, E_local, C, M]: chunk j to rank j, which returns the slots
            # of its experts from every rank; the FFN sees [E_local, ep, C, M]
            slots = all_to_all(dispatched.reshape(self.ep_size, self.num_local_experts, capacity,
                                                  M), self.group)
            out = self._expert_ffn(params["experts"], slots.transpose(0, 1)).transpose(0, 1)
            expert_out = all_to_all(out, self.group).reshape(E, capacity, M)
        else:
            expert_out = self._expert_ffn(params["experts"], dispatched.reshape(
                self.num_local_experts, -1, capacity, M)).reshape(E, capacity, M)
        return torch.einsum("sec,ecm->sm", combine.to(x.dtype), expert_out), l_aux
