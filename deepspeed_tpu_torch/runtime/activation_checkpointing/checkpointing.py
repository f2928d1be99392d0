"""Activation checkpointing: ``checkpoint`` under named remat policies, and
RNG streams that replay in the recompute.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py``, which hands a policy to ``jax.checkpoint``. Here the
mechanism is ``torch.utils.checkpoint`` without reentrance: the forward of a
checkpointed function keeps its inputs and drops what autograd would save,
and the backward runs the function again where it first needs a dropped
tensor. A named policy chooses what the forward keeps after all, as a
selective-checkpoint policy (``create_selective_checkpoint_contexts``) over
the ops the dispatcher sees:

  * ``nothing_saveable`` (the default): keep nothing, recompute everything.
  * ``dots_saveable`` / ``checkpoint_dots``: keep the outputs of ``mm``,
    ``addmm`` and ``bmm``.
  * ``dots_with_no_batch_dims_saveable`` /
    ``checkpoint_dots_with_no_batch_dims``: ``mm`` and ``addmm``, not ``bmm``.
  * ``everything_saveable``: no checkpoint at all.
  * ``save_only_these_names(a,b,...)``: keep exactly the values tagged with
    those names by :func:`checkpoint_name` (an op of the dispatcher, so the
    policy sees it; inside such a region it copies the value, elsewhere it
    is the value itself).

A recompute runs every op of the function again, the kept ones excepted,
which hand back what the forward computed; a hand-written kernel called
through ctypes is not an op, so it runs again in every recompute.

RNG. ``torch.utils.checkpoint`` replays the default CPU and CUDA generators
only. :func:`checkpoint` also snapshots the state of every
``torch.Generator`` among its arguments (in lists, tuples and dicts too) and
of the tracker's streams, sets them back before the recompute and, after it,
to where the rest of the program had left them: a dropout or a sampled
routing drawn inside replays exactly, and nothing outside sees the backward
draw.

``cpu_checkpointing``: the inputs of a region the configured policy
checkpoints (the residual stream between blocks, which is what a region
keeps; the reference's ``offload_policy`` offloads the values tagged
``residual``) live in pinned host memory until the recompute brings them
back, and everything else is recomputed. A copy through an autograd
``Function`` does it: the region holds its inputs outside autograd's
saved-tensor hooks, where ``save_on_cpu`` does not reach.

``partition_activations`` spreads kept activations over the ``seq`` and
``model`` axes in the reference; the port refuses both axes above 1
(``parallel/mesh.py``), so it is accepted as the no-op it is there.
``contiguous_memory_optimization``, ``number_checkpoints`` and ``profile``
are kept and change nothing, as in the reference;
``synchronize_checkpoint_boundary`` synchronises the card after each
region's forward.
"""

import contextlib
import threading
from typing import Callable, List, NamedTuple, Optional

import torch
from torch.utils import checkpoint as _torch_checkpoint

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"

# ---------------------------------------------------------------------------
# the tag: an op the selective policy can see
# ---------------------------------------------------------------------------

if not hasattr(torch.ops.deepspeed_tpu_torch, "checkpoint_name"):

    @torch.library.custom_op("deepspeed_tpu_torch::checkpoint_name", mutates_args=())
    def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
        return x.clone()

    @_tag.register_fake
    def _tag_fake(x, name):
        return torch.empty_like(x)

    _tag.register_autograd(lambda ctx, grad: (grad, None))

_TAG = torch.ops.deepspeed_tpu_torch.checkpoint_name.default
_tagging = threading.local()  # .names: the names the innermost running region keeps


def checkpoint_name(name: str, x: torch.Tensor) -> torch.Tensor:
    """Tag ``x`` for ``save_only_these_names`` policies: inside a region
    whose policy names ``name``, a copy the policy keeps; elsewhere ``x``."""
    names = getattr(_tagging, "names", None)
    if names is None or name not in names:
        return x
    return _TAG(x, name)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

_MM = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
_BMM = frozenset({torch.ops.aten.bmm.default})
_NAMES_PREFIX = "save_only_these_names("


class Policy(NamedTuple):
    """A resolved remat policy: ``name`` as configured, ``checkpoint``
    (False: run the function plainly), ``ops`` (outputs kept) and ``names``
    (tags kept), or ``fn``, a selective-checkpoint policy function of one's
    own."""
    name: str
    checkpoint: bool = True
    ops: frozenset = frozenset()
    names: frozenset = frozenset()
    fn: Optional[Callable] = None

    def selective(self) -> bool:
        return bool(self.ops or self.names or self.fn)


_POLICIES = {
    "nothing_saveable": Policy("nothing_saveable"),
    "dots_saveable": Policy("dots_saveable", ops=_MM | _BMM),
    "checkpoint_dots": Policy("checkpoint_dots", ops=_MM | _BMM),
    "dots_with_no_batch_dims_saveable": Policy("dots_with_no_batch_dims_saveable", ops=_MM),
    "checkpoint_dots_with_no_batch_dims": Policy("checkpoint_dots_with_no_batch_dims", ops=_MM),
    "everything_saveable": Policy("everything_saveable", checkpoint=False),
}


def resolve_policy(name_or_policy=None) -> Policy:
    """A policy name (the config's string; None is ``nothing_saveable``), a
    :class:`Policy`, or a selective-checkpoint policy function ``(ctx, op,
    *args, **kwargs) -> CheckpointPolicy``. ValueError names an unknown
    name and lists the known ones."""
    if name_or_policy is None:
        return _POLICIES["nothing_saveable"]
    if isinstance(name_or_policy, Policy):
        return name_or_policy
    if callable(name_or_policy):
        return Policy(getattr(name_or_policy, "__name__", "custom"), fn=name_or_policy)
    name = str(name_or_policy)
    if name.startswith(_NAMES_PREFIX) and name.endswith(")"):
        names = frozenset(n.strip() for n in name[len(_NAMES_PREFIX):-1].split(",") if n.strip())
        return Policy(name, names=names)
    if name not in _POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; known: {sorted(_POLICIES)} and "
                         f"'save_only_these_names(a,b,...)'")
    return _POLICIES[name]


def _sac_policy(policy: Policy):
    """The selective-checkpoint policy function of ``policy``."""
    if policy.fn is not None:
        return policy.fn
    keep, recompute = (_torch_checkpoint.CheckpointPolicy.MUST_SAVE,
                       _torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)

    def fn(ctx, op, *args, **kwargs):
        if op in policy.ops or (op is _TAG and args[1] in policy.names):
            return keep
        return recompute

    return fn


# ---------------------------------------------------------------------------
# module state (the reference's module-level configure() globals)
# ---------------------------------------------------------------------------

class _CkptState:

    def __init__(self):
        self.configured = False
        self.policy = None
        self.partition_activations = False
        self.cpu_checkpointing = False
        self.contiguous_memory_optimization = False
        self.num_checkpoints = None
        self.synchronize = False
        self.profile = False


_state = _CkptState()


def configure(mpu_=None,
              deepspeed_config=None,
              partition_activations=None,
              contiguous_checkpointing=None,
              checkpoint_in_cpu=None,
              synchronize=None,
              profile=None,
              num_checkpoints=None,
              remat_policy=None):
    """Configure the module's state (the reference's ``configure``): an
    explicit keyword wins over the ds_config's ``activation_checkpointing``
    block, which wins over the default."""
    cfg = None
    if deepspeed_config is not None:
        from ..config import DeepSpeedConfig

        ds = (deepspeed_config if isinstance(deepspeed_config, DeepSpeedConfig) else
              DeepSpeedConfig(deepspeed_config))
        cfg = ds.activation_checkpointing_config

    def pick(explicit, field, default):
        if explicit is not None:
            return explicit
        return getattr(cfg, field) if cfg is not None else default

    # an unknown name raises before any state changes
    policy = resolve_policy(pick(remat_policy, "remat_policy", "nothing_saveable"))
    _state.partition_activations = pick(partition_activations, "partition_activations", False)
    _state.contiguous_memory_optimization = pick(contiguous_checkpointing,
                                                 "contiguous_memory_optimization", False)
    _state.cpu_checkpointing = pick(checkpoint_in_cpu, "cpu_checkpointing", False)
    _state.synchronize = pick(synchronize, "synchronize_checkpoint_boundary", False)
    _state.profile = pick(profile, "profile", False)
    _state.num_checkpoints = pick(num_checkpoints, "number_checkpoints", None)
    # cpu_checkpointing: nothing kept on the device, the inputs on the host
    _state.policy = _POLICIES["nothing_saveable"] if _state.cpu_checkpointing else policy
    _state.configured = True


def is_configured() -> bool:
    return _state.configured


def reset() -> None:
    """Back to the defaults, unconfigured (the reference's ``reset``)."""
    _state.__init__()


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _generators(tree, out: List[torch.Generator]) -> List[torch.Generator]:
    """Every ``torch.Generator`` in ``tree`` (lists, tuples, dicts)."""
    if isinstance(tree, torch.Generator):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _generators(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _generators(t, out)
    return out


class _HostCopy(torch.autograd.Function):
    """A device tensor -> its copy in pinned host memory; the gradient goes
    back to the device."""

    @staticmethod
    def forward(ctx, x):
        ctx.device = x.device
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.device, non_blocking=True)


def _offload(args):
    """``args`` with each floating CUDA tensor as a pinned host copy, and
    the devices to bring them back to."""
    moved, devices = [], []
    for a in args:
        if torch.is_tensor(a) and a.is_cuda and a.is_floating_point():
            devices.append(a.device)
            moved.append(_HostCopy.apply(a))
        else:
            devices.append(None)
            moved.append(a)
    return moved, devices


def _replayed(args) -> List[torch.Generator]:
    """The generators a region replays: those among its arguments and the
    tracker's streams."""
    return _generators(args, []) + list(_RNG_TRACKER.states_.values())


def _run_checkpointed(function: Callable, args, policy: Policy, offload: bool):
    """``function(*args)`` under ``torch.utils.checkpoint`` with ``policy``;
    the generators of :func:`_replayed` replay in the recompute."""
    gens = _replayed(args)
    saved = [g.get_state() for g in gens]
    names = policy.names or None
    devices = None
    if offload:
        args, devices = _offload(args)
    calls = [0]

    def run(*a):
        recompute = calls[0] > 0
        calls[0] += 1
        if devices is not None:
            a = [x if d is None else x.to(d, non_blocking=True) for x, d in zip(a, devices)]
        outer_names = getattr(_tagging, "names", None)
        _tagging.names = names
        now = None
        try:
            if recompute:  # draw what the forward drew; then leave the streams as they were
                now = [g.get_state() for g in gens]
                for g, s in zip(gens, saved):
                    g.set_state(s)
            return function(*a)
        finally:
            _tagging.names = outer_names
            if now is not None:
                for g, s in zip(gens, now):
                    g.set_state(s)

    kw = {}
    if policy.selective():
        sac = _sac_policy(policy)
        kw["context_fn"] = lambda: _torch_checkpoint.create_selective_checkpoint_contexts(sac)
    out = _torch_checkpoint.checkpoint(run, *args, use_reentrant=False, **kw)
    if _state.synchronize and torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def checkpoint(function: Callable, *args, policy=None):
    """Checkpoint ``function`` applied to ``*args`` (the reference's
    ``checkpoint``): its outputs, with what autograd saves dropped and
    recomputed in the backward under ``policy`` (a name, a :class:`Policy`
    or a selective-checkpoint policy function; None: the configured one).
    With no ``args``, the checkpointed function itself (decorator form).
    Without gradients the function just runs."""
    if not args:
        return lambda *a: checkpoint(function, *a, policy=policy)
    if not _state.configured:
        configure()
    pol = resolve_policy(policy) if policy is not None else _state.policy
    if not pol.checkpoint or not torch.is_grad_enabled():
        return function(*args)
    return _run_checkpointed(function, args, pol,
                             offload=policy is None and _state.cpu_checkpointing)


def non_reentrant_checkpoint(function: Callable, *args, **kwargs):
    """The reference's ``non_reentrant_checkpoint``: :func:`checkpoint`,
    which is non-reentrant already."""
    return checkpoint(function, *args, **kwargs)


# the reference's exported class name
CheckpointFunction = checkpoint


# ---------------------------------------------------------------------------
# RNG streams (the reference's CudaRNGStatesTracker): host generators, each
# fork a device generator seeded from its stream
# ---------------------------------------------------------------------------

def model_parallel_rng_tracker_name() -> str:
    return _MODEL_PARALLEL_RNG_TRACKER_NAME


class RNGStatesTracker:
    """Named random streams, each a host ``torch.Generator``. ``split(name,
    device)`` draws a seed from the stream (advancing it) and returns a new
    generator on ``device`` seeded with it; ``fork`` yields one. A
    :func:`checkpoint` region replays the streams, so a fork inside draws
    the same in its recompute."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_.clear()

    def get_states(self):
        """{name: the stream's state} (copies)."""
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states):
        """Streams at ``states`` (from :meth:`get_states`)."""
        self.states_ = {}
        for name, state in states.items():
            g = torch.Generator()
            g.set_state(state)
            self.states_[name] = g

    def add(self, name, seed):
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        self.states_[name] = torch.Generator().manual_seed(int(seed))

    def split(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME, device=None) -> torch.Generator:
        """A fresh generator on ``device`` (default: the card) seeded from
        the named stream, which advances."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        from ...models.transformer import resolve_device

        seed = int(torch.randint(0, 2**62, (), generator=self.states_[name]))
        return torch.Generator(device=resolve_device(device)).manual_seed(seed)

    @contextlib.contextmanager
    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME, device=None):
        """Yields :meth:`split`'s generator for the region."""
        yield self.split(name, device)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _RNG_TRACKER


# the reference exports it under the CUDA name as well
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_reconfigure_tp_seed(seed):
    """The reference's ``model_parallel_cuda_manual_seed``: the
    model-parallel stream seeded anew (one tensor-parallel rank: the port
    refuses the ``model`` axis above 1)."""
    _RNG_TRACKER.states_.pop(_MODEL_PARALLEL_RNG_TRACKER_NAME, None)
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME, seed)


def partition_activations_wrapper(fn: Callable) -> Callable:
    """The reference's wrapper that constrains activations over the ``seq``
    and ``model`` axes: both are 1 in the port, so ``fn`` itself."""
    return fn


__all__ = ["CheckpointFunction", "Policy", "RNGStatesTracker", "checkpoint", "checkpoint_name",
           "configure", "get_cuda_rng_tracker", "get_rng_tracker", "is_configured",
           "model_parallel_reconfigure_tp_seed", "model_parallel_rng_tracker_name",
           "non_reentrant_checkpoint", "partition_activations_wrapper", "reset",
           "resolve_policy"]
