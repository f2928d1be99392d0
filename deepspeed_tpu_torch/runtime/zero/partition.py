"""ZeRO stages 0-3 at data-parallel world size >= 2, over flat fp32 shards.

Counterpart of ``deepspeed_tpu/runtime/zero/partition.py``. In the JAX
package ZeRO is a set of sharding rules that XLA turns into collectives:

    stage | params     | grads      | optimizer state
    0     | replicated | replicated | replicated
    1     | replicated | replicated | sharded
    2     | replicated | sharded    | sharded
    3     | sharded    | sharded    | sharded

PyTorch has no compiler to insert those collectives, so :class:`ZeroPartition`
issues them itself over the data-parallel process group (``comm``):

- stage 0: the parameters are views of one full flat fp32 buffer per group
  and their ``.grad`` views of a full flat gradient buffer; each group's
  gradient is summed over the ranks (``all_reduce``) at the end of the
  step, and the optimizer updates the full buffers.
- stage 1: the same gradients; the optimizer updates this rank's shard of
  each group only (its moments are shard-sized), then
  ``all_gather_into_tensor`` puts the updated shards back together.
- stage 2: a post-accumulate-grad hook on every leaf copies the leaf's
  gradient into its group's transient full buffer and frees it; once every
  leaf of the group has arrived, ``reduce_scatter_tensor`` sums the buffer
  into this rank's gradient shard and the buffer is dropped. Then as stage 1.
- stage 3: the autograd leaves are the shards. :class:`GatherGroup`
  all-gathers a group where the forward reaches it, and its backward
  reduce-scatters the group's gradient into the shard's ``.grad``, so
  ``AccumulateGrad`` never sees a full-size gradient. No fp32 copy of a
  whole group is gathered: the leaves the model uses in fp32 come as one
  small fp32 region, the rest as every rank's shard cast to the compute
  dtype, then gathered (half the bytes). What autograd saves of those (a
  matmul's weight) is saved as its place in the group
  (:meth:`ZeroPartition.regather_in_backward`), and the backward gathers
  the group again where it first needs it, so a layer's gathered weights
  die with its forward and no rank holds the whole model's compute-dtype
  weights.

Expert parallelism. A leaf marked as upstream DeepSpeed marks expert
parameters (``allreduce = False``) stays out of its group's flat buffer,
this rank's experts in fp32 with their gradient and moments, at every
stage (the reference shards ``moe_wi`` / ``moe_wg`` / ``moe_wo`` over the
data axis, ``P(PIPE, DATA, ...)``: that is their ZeRO sharding). A leaf
holding every expert (a ``TransformerLM``'s) whose leading dim the world
divides becomes rank r's experts ``[r * E / world, (r + 1) * E / world)``
of rank 0's initial tensor (``scatter``), so world sizes 1 and N start
from the same weights, and is named ``group_name = "ep_size_<world>"``;
a leaf that already carries that name holds this rank's experts (a
``moe.MoE(ep_size=world)`` layer's, or an earlier partition's) and is
kept as it is. The einsum path exchanges token slots with the owners
(``moe.sharded_moe.all_to_all``), so an owner's expert gradient is whole
after the backward and no collective sums it. The grouped path takes
every expert: :class:`GatherExperts` all-gathers a block's experts in the
compute dtype where the forward reaches the block and reduce-scatters
their gradients to the owners in its backward, at every stage, and what
autograd saves of them is gathered again in the backward as at stage 3.
A marked leaf the world does not divide stays in its group (the
reference replicates the expert dim then), as do ``ep_size_1`` experts.

The groups are the model's (``zero_groups()``: the embedding, the final
norm and head, then one per transformer block); any other module is one
group. A group's buffer holds its leaves in the model's order, the fp32
ones first, each starting at a multiple of ``ALIGN`` elements, and is
padded to ``world * shard`` elements with ``shard = round_up(ceil(numel /
world), ALIGN)``: rank r owns elements ``[r * shard, (r + 1) * shard)``,
and every shard starts on a 64-byte boundary (the fused AdamW kernel's
vector path).

Why flat shards compute what the reference's per-leaf specs compute. The
reference shards each leaf along its largest divisible dimension
(``add_data_axes``); here a shard cuts across leaves. ZeRO moves where the
arithmetic happens, not what it is: AdamW is elementwise (an element's
update reads its own gradient, parameter and moments and the step's
scalars), and clipping and the overflow gate read the global norm, the
square root of a sum of squares over every element, which is the same sum
however the elements are split (one ``all_reduce`` of the shards' partial
sums; the owned experts' partial sums join that one ``all_reduce``, at
stages 0-1 too). Padding elements hold zero parameters, gradients and
moments, and AdamW keeps them zero. What can differ from one replicated
device is the fp32 summation order of the gradient sum over ranks and of
the norm.

Each rank's loss is weighted by the engine so that the sum over ranks is
``world`` times the loss of the global microbatch; the gradients are
summed over ranks and divided by ``gas * world``.

The newest partition over a model owns its parameters: it rebinds them to
its buffers and takes the stage-2 hooks of an earlier one off them, and a
partition's hooks go with it, so a dropped engine leaves the model's own
backward alone.

Tensor parallelism (the ``model`` mesh axis). The reference's
``ZeroShardingPolicy`` applies the tensor-parallel specs first
(:class:`PartitionRules`, :func:`sanitize_spec`) and then ZeRO-shards over
the data axes. Here the model's parameters already are this rank's
tensor-parallel shards (``models.TensorParallel``), so the partition is
built from them over the data group alone: the ranks of a data group share
a model index and hold shards of the same shapes. The gradient norm is the
norm of the whole logical model: a parameter marked
``tensor_model_parallel`` (Megatron's mark; split over the model group) adds
its square sum on every model rank, and any other (norm scales, ``bo``,
``b_down``, what :func:`sanitize_spec` replicated: the same on every model
rank) on model rank 0 alone, as Megatron counts them. The square sums are
then summed over the world at stages 1-3 (data shards and model shards) and
over the model group at stage 0.
"""

import contextlib
import math
import re
import warnings
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ... import comm
from ..utils import global_norm

ALIGN = 16  # fp32 elements: 64 bytes


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _sum_squares(tensors) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(tensors)).square().sum()


# ---------------------------------------------------------------------------
# tensor-parallel specs (partition.py:58-115 of the JAX package)
# ---------------------------------------------------------------------------

class PartitionRules:
    """Ordered (regex, spec) table mapping parameter paths to tensor-parallel
    specs: a spec is a tuple with one entry a dim, a mesh axis name (or a
    tuple of them) or None (the reference's ``PartitionSpec`` entries).
    First match wins; no match replicates. Paths are ``group/name``: a
    trainable model's per-layer blocks are ``blocks/<name>`` (the layer
    index is not part of the path), and the specs are per layer."""

    def __init__(self, rules: Optional[Sequence[Tuple[str, tuple]]] = None):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in (rules or [])]

    def spec_for(self, path: str, ndim: int) -> tuple:
        for pat, spec in self.rules:
            if pat.search(path):
                entries = list(spec) + [None] * (ndim - len(spec))
                return tuple(entries[:ndim])
        return (None, ) * ndim

    def tree_specs(self, params) -> Any:
        """The spec of every leaf of a port parameter tree, in its structure.
        ``blocks`` held as a dict of ``[L, ...]`` tensors (the serving
        layout) gets a leading None for the layer dim."""

        def walk(node, path, lead):
            if isinstance(node, dict):
                return {k: walk(v, f"{path}/{k}", lead) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v, path, lead) for v in node]
            return (None, ) * lead + self.spec_for(path, node.dim() - lead)

        return {g: walk(v, g, int(g == "blocks" and isinstance(v, dict)))
                for g, v in params.items()}


def sanitize_spec(spec: tuple, shape: Sequence[int], sizes: Dict[str, int],
                  path: str = "") -> tuple:
    """Drop the spec entries whose axes' product does not divide the dim
    (``sizes``: each mesh axis's size): that dim is replicated instead,
    loudly, so a size the axis does not divide never silently disables the
    split elsewhere (reference ``sanitize_spec``)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for i, e in enumerate(entries[:len(shape)]):
        if e is None:
            out.append(None)
            continue
        keep, size = [], shape[i]
        for a in (e if isinstance(e, (tuple, list)) else (e, )):
            n = sizes.get(a, 1)
            if n <= 1:
                continue
            if size % n == 0:
                keep.append(a)
                size //= n
            else:
                warnings.warn(f"partition rule for {path or 'param'} dim {i} (size {shape[i]}) is "
                              f"not divisible by mesh axis '{a}' ({n}); replicating that dim "
                              f"instead")
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


def is_model_parallel(p) -> bool:
    """Megatron's mark of a tensor-parallel shard (``tensor_model_parallel``):
    the parameter holds this rank's slice along ``p.partition_dim``."""
    return bool(getattr(p, "tensor_model_parallel", False))


class Leaf(NamedTuple):
    key: Any
    shape: torch.Size
    offset: int
    low: bool  # the model casts it to the compute dtype where it uses it

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


class FlatGroup:
    """One group's layout in its flat buffer (see the module docstring).
    ``entries``: (key, shape, low) of each leaf in the model's order."""

    def __init__(self, name: str, entries: Sequence[Tuple[Any, Sequence[int], bool]], world: int):
        self.name = name
        ordered = [e for e in entries if not e[2]] + [e for e in entries if e[2]]
        self.leaves: List[Leaf] = []
        self.n_keep = None  # where the first low leaf starts (the fp32 region's end)
        off = end = 0
        for key, shape, low in ordered:
            if low and self.n_keep is None:
                self.n_keep = off
            leaf = Leaf(key, torch.Size(shape), off, bool(low))
            self.leaves.append(leaf)
            end = off + leaf.numel
            off = round_up(end, ALIGN)
        self.numel = end
        if self.n_keep is None:
            self.n_keep = end
        self.shard = round_up(-(-self.numel // world), ALIGN)
        self.padded = self.shard * world

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [flat[l.offset:l.offset + l.numel].view(l.shape) for l in self.leaves]

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """A zeroed fp32 buffer of ``padded`` elements holding ``tensors``
        (in leaf order) at their offsets."""
        flat = torch.zeros(self.padded, dtype=torch.float32, device=tensors[0].device)
        for view, t in zip(self.views(flat), tensors):
            view.copy_(t)
        return flat

    def shard_of(self, flat: torch.Tensor, rank: int) -> torch.Tensor:
        return flat[rank * self.shard:(rank + 1) * self.shard]


def _gathered(shard, fg: FlatGroup, dtype, group) -> List[torch.Tensor]:
    """Group ``fg``'s buffers from every rank's shard: with ``dtype`` fp32
    the gathered buffer; else the fp32 region (every rank's first ``min(
    shard, n_keep)`` elements gathered: rank 0's alone where they cover
    it) and every rank's shard cast to ``dtype``, gathered (no fp32 copy of
    the group is made)."""
    if dtype == torch.float32:
        full = shard.new_empty(fg.padded)
        comm.all_gather_into_tensor(full, shard, group=group)
        return [full]
    k = min(fg.shard, fg.n_keep)
    keep = shard.new_empty(comm.get_world_size(group) * k)
    if k:
        comm.all_gather_into_tensor(keep, shard[:k], group=group)
    low = shard.new_empty(fg.padded, dtype=dtype)
    comm.all_gather_into_tensor(low, shard.to(dtype), group=group)
    return [keep, low]


def _gathered_expert(shard, dtype, group) -> torch.Tensor:
    """One expert leaf whole, ``[world * n, ...]`` in ``dtype``, from every
    rank's ``[n, ...]`` (rank r's experts at rows ``[r * n, (r + 1) * n)``)."""
    full = shard.new_empty((comm.get_world_size(group) * shard.shape[0], *shard.shape[1:]),
                           dtype=dtype)
    comm.all_gather_into_tensor(full, shard.to(dtype).contiguous(), group=group)
    return full


def _leaf_views(fg: FlatGroup, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every leaf of ``fg`` as a view of its buffer from :func:`_gathered`."""
    if len(bufs) == 1:
        return fg.views(bufs[0])
    return [bufs[int(l.low)][l.offset:l.offset + l.numel].view(l.shape) for l in fg.leaves]


class GatherGroup(torch.autograd.Function):
    """ZeRO-3's gather of one group: its fp32 shard -> every leaf, in leaf
    order, as views of :func:`_gathered`'s buffers. Backward: ``done()``
    (every use of the group's weights is behind it), then the leaves'
    gradients into one full fp32 buffer, summed over ranks into this rank's
    shard (``reduce_scatter_tensor``)."""

    @staticmethod
    def forward(ctx, shard, fg: FlatGroup, dtype, group, done):
        ctx.fg, ctx.group, ctx.done = fg, group, done
        return tuple(_leaf_views(fg, _gathered(shard, fg, dtype, group)))

    @staticmethod
    def backward(ctx, *grads):
        ctx.done()
        fg = ctx.fg
        dev = next(g for g in grads if g is not None).device
        full = torch.zeros(fg.padded, dtype=torch.float32, device=dev)
        for view, g in zip(fg.views(full), grads):
            if g is not None:
                view.copy_(g)
        out = full.new_empty(fg.shard)
        comm.reduce_scatter_tensor(out, full, group=ctx.group)
        return out, None, None, None, None


class GatherExperts(torch.autograd.Function):
    """The grouped path's gather of one block's expert leaves: this rank's
    fp32 experts -> each leaf whole in ``dtype``. Backward: ``done()``, then
    each leaf's gradient (in fp32) summed over the ranks into the owners'
    experts (``reduce_scatter_tensor``)."""

    @staticmethod
    def forward(ctx, dtype, group, done, *owned):
        ctx.group, ctx.done = group, done
        return tuple(_gathered_expert(p, dtype, group) for p in owned)

    @staticmethod
    def backward(ctx, *grads):
        ctx.done()
        world = comm.get_world_size(ctx.group)
        outs = []
        for g in grads:
            summed = None
            if g is not None:
                whole = g.float().contiguous()
                summed = whole.new_empty((whole.shape[0] // world, *whole.shape[1:]))
                comm.reduce_scatter_tensor(summed, whole, group=ctx.group)
            outs.append(summed)
        return (None, None, None, *outs)


def is_expert(p) -> bool:
    """The upstream mark of an expert parameter (``allreduce = False``)."""
    return getattr(p, "allreduce", True) is False


def _expert_parallel(p, world: int) -> bool:
    """Whether the partition keeps ``p`` out of the flat groups: an expert
    leaf that holds this rank's experts already (named for ``world``), or
    every expert, as many as ``world`` divides. Experts of ``ep_size_1``
    are replicated over the data group, as any other leaf."""
    if not is_expert(p):
        return False
    name = getattr(p, "group_name", None)
    if name is None:
        return p.shape[0] % world == 0
    if name == "ep_size_1":
        return False
    if name != f"ep_size_{world}":
        raise NotImplementedError(f"experts of expert group {name!r} at data-parallel world size "
                                  f"{world}: only the whole data group holds experts")
    return True


def _module_groups(module, params):
    """``module.zero_groups()``, else one group of its trainable parameters
    (none kept apart for a cast); checked to cover ``params`` exactly."""
    if hasattr(module, "zero_groups"):
        spec = module.zero_groups()
    else:
        spec = [("params", [(name, p, False) for name, p in module.named_parameters()
                            if p.requires_grad])]
    got = [id(p) for _, entries in spec for _, p, _ in entries]
    if sorted(got) != sorted(id(p) for p in params) or len(set(got)) != len(got):
        raise ValueError("the ZeRO groups must hold each trainable parameter exactly once")
    return spec


def _remove_hooks(handles) -> None:
    for h in handles:
        h.remove()


class ZeroPartition:
    """The engine's ZeRO state at data-parallel world size >= 2 over
    ``group`` (see the module docstring). Rank 0's parameters are
    broadcast first (the owned experts scattered), so every rank starts
    from the same masters. ``model_group``: the tensor-parallel group of
    a model whose parameters are this rank's shards (None without)."""

    def __init__(self, module, params: Sequence[nn.Parameter], stage: int, group, compute_dtype,
                 model_group=None):
        self.stage = stage
        self.group = group
        self.model_group = model_group
        self.world = comm.get_world_size(group)
        self.rank = comm.get_rank(group)
        self.compute_dtype = compute_dtype
        self.groups: List[FlatGroup] = []
        self.leaf_params: List[List[nn.Parameter]] = []  # the model's parameters, in leaf order
        self.flats: List[torch.Tensor] = []  # stages 0-2: the full parameters
        self.shards: List[nn.Parameter] = []  # stage 3: this rank's parameter shards
        self.grad_flats: List[torch.Tensor] = []  # stages 0-1: the full gradients
        self.grad_shards: List[torch.Tensor] = []  # stage 2
        self._bufs: List = []  # stage 2: each group's transient full gradient
        self._pending: List[int] = []  # stage 2: leaves still to arrive this backward
        hooks = []  # stage 2: the handles of the hooks on the model's parameters
        # storage address -> (a gathered buffer, weakly; its gather's key:
        # the group, or ("experts", group); its index in what _regather
        # returns) while a forward runs; and the gather the backward made
        # again, with its buffers
        self._live: Dict[int, Tuple[weakref.ref, Any, int]] = {}
        self._regathered = None
        # each group's expert-parallel leaves, (key, parameter) in the
        # model's order: the parameters hold this rank's experts
        self.expert_leaves: List[List[Tuple[Any, nn.Parameter]]] = []
        # each group's element ranges this rank adds to the norm (None: all)
        self._counted: List[Optional[List[Tuple[int, int]]]] = []
        for name, entries in _module_groups(module, params):
            owned = [(k, p) for k, p, _ in entries if _expert_parallel(p, self.world)]
            entries = [e for e in entries if not any(e[1] is p for _, p in owned)]
            if not entries:
                raise ValueError(f"ZeRO group {name!r} holds experts only: keep a non-expert "
                                 f"leaf beside them")
            self.expert_leaves.append(owned)
            for _, p in owned:
                self._own_experts(p)
            fg = FlatGroup(name, [(k, p.shape, low) for k, p, low in entries], self.world)
            by_key = {k: p for k, p, _ in entries}
            ps = [by_key[l.key] for l in fg.leaves]
            self.groups.append(fg)
            self.leaf_params.append(ps)
            self._counted.append(self._counted_ranges(fg, ps))
            with torch.no_grad():
                flat = fg.flatten([p.detach() for p in ps])
            comm.broadcast(flat, src=comm.get_global_rank(group, 0), group=group)
            if stage == 3:
                shard = nn.Parameter(fg.shard_of(flat, self.rank).clone())
                shard.grad = torch.zeros_like(shard)
                self.shards.append(shard)
                for p in ps:  # the full-size masters are freed: the shard is the master
                    p.data = torch.empty(0, dtype=p.dtype, device=p.device)
                continue
            self.flats.append(flat)
            for p, view in zip(ps, fg.views(flat)):
                p.data = view
            if stage <= 1:
                gflat = torch.zeros_like(flat)
                self.grad_flats.append(gflat)
                for p, view in zip(ps, fg.views(gflat)):
                    p.grad = view
            else:
                self.grad_shards.append(torch.zeros(fg.shard, dtype=torch.float32,
                                                    device=flat.device))
                self._bufs.append(None)
                self._pending.append(len(ps))
                for li, p in enumerate(ps):
                    earlier = getattr(p, "_zero_grad_hook", None)
                    if earlier is not None:  # an earlier partition's over this model
                        earlier.remove()
                    p._zero_grad_hook = p.register_post_accumulate_grad_hook(
                        self._stage2_hook(len(self.groups) - 1, li))
                    hooks.append(p._zero_grad_hook)
        weakref.finalize(self, _remove_hooks, hooks)

    def _own_experts(self, p: nn.Parameter) -> None:
        """``p`` -> this rank's experts with a zero gradient: where it holds
        every expert (its whole initial value on every rank), this rank's
        slice of rank 0's value."""
        if getattr(p, "group_name", None) is None:
            n = p.shape[0] // self.world
            with torch.no_grad():
                mine = p.detach().new_empty((n, *p.shape[1:]))
                src = comm.get_global_rank(self.group, 0)
                chunks = list(p.detach().split(n)) if self.rank == 0 else None
                comm.scatter(mine, chunks, src=src, group=self.group)
            p.data = mine
            p.group_name = f"ep_size_{self.world}"
        p.grad = torch.zeros_like(p.detach())

    def _counted_ranges(self, fg: FlatGroup, ps) -> Optional[List[Tuple[int, int]]]:
        """The ranges of group ``fg``'s gradient tensor (the full buffer at
        stage 0, this rank's shard above) whose squares this rank adds to
        the norm: all (None) without tensor parallelism and on model rank 0;
        elsewhere the tensor-parallel leaves' elements alone (a replicated
        leaf counts once, on model rank 0)."""
        if self.model_group is None or comm.get_rank(self.model_group) == 0:
            return None
        lo_w, hi_w = ((0, fg.padded) if self.stage == 0 else
                      (self.rank * fg.shard, (self.rank + 1) * fg.shard))
        out = []
        for leaf, p in zip(fg.leaves, ps):
            lo, hi = max(leaf.offset, lo_w), min(leaf.offset + leaf.numel, hi_w)
            if is_model_parallel(p) and lo < hi:
                out.append((lo - lo_w, hi - lo_w))
        return out

    @property
    def experts(self) -> List[nn.Parameter]:
        """The expert-parallel parameters (this rank's experts), in order."""
        return [p for ex in self.expert_leaves for _, p in ex]

    def gathers(self, whole_experts: bool) -> bool:
        """Whether the forward takes its parameters from :meth:`gather`: at
        stage 3, and where a model that multiplies by every expert
        (``whole_experts``: the grouped path) has expert-parallel experts.
        Elsewhere the model's own parameters are the ones to use: this
        rank's experts and the flat buffers' views."""
        return self.stage == 3 or (whole_experts and bool(self.experts))

    # ------------------------------------------------------------------
    # what the optimizer updates
    # ------------------------------------------------------------------
    def optimizer_params(self) -> List[torch.Tensor]:
        """The tensors the optimizer updates, each with its ``.grad`` set:
        the full buffers at stage 0, this rank's shards at stages 1-3, then
        this rank's experts."""
        if self.stage == 3:
            return list(self.shards) + self.experts
        out = []
        for fg, flat, grad in zip(self.groups, self.flats, self._flat_grads()):
            t = flat if self.stage == 0 else fg.shard_of(flat, self.rank)
            t.grad = grad
            out.append(t)
        return out + self.experts

    def _flat_grads(self) -> List[torch.Tensor]:
        if self.stage == 0:
            return self.grad_flats
        if self.stage == 1:
            return [fg.shard_of(g, self.rank) for fg, g in zip(self.groups, self.grad_flats)]
        if self.stage == 2:
            return self.grad_shards
        return [s.grad for s in self.shards]

    def grads(self) -> List[torch.Tensor]:
        """The gradients the optimizer reads, in ``optimizer_params`` order."""
        return self._flat_grads() + [p.grad for p in self.experts]

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of :meth:`grads` (a device scalar): the flat
        gradients' squares summed over the ranks where they are shards, the
        owned experts' at every stage. Under tensor parallelism the norm of
        the whole logical model (the module docstring): each rank's counted
        ranges, summed over the world at stages 1-3, over the model group at
        stage 0."""
        n = len(self.groups)
        flat, owned = list(grads[:n]), list(grads[n:])
        if self.model_group is not None:
            parts = [piece for g, ranges in zip(flat, self._counted)
                     for piece in ([g] if ranges is None else [g[lo:hi] for lo, hi in ranges])]
            local = _sum_squares(parts) if parts else flat[0].new_zeros(())
            group = None if self.sharded_grads else self.model_group
            return comm.all_reduce(local, group=group).sqrt()
        if not owned:
            return global_norm(flat, self.group if self.sharded_grads else None)
        local = _sum_squares(owned)
        if self.sharded_grads:
            local = local + _sum_squares(flat)
        total = comm.all_reduce(local, group=self.group)
        if not self.sharded_grads:
            total = total + _sum_squares(flat)
        return total.sqrt()

    @property
    def sharded_grads(self) -> bool:
        """Whether the gradients the optimizer reads are shards (their norm
        then sums over the ranks)."""
        return self.stage >= 1

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def zero_grad(self) -> None:
        bufs = self.grad_flats if self.stage <= 1 else self._flat_grads()
        torch._foreach_zero_(bufs + [p.grad for p in self.experts])

    def _stage2_hook(self, gi: int, li: int):
        # the hook holds the partition weakly: torch's collector does not
        # see a tensor's post-accumulate hooks, so a strong reference there
        # would keep the partition's buffers alive after the engine is gone
        partition = weakref.ref(self)

        def hook(p):
            z = partition()
            fg = z.groups[gi]
            if z._bufs[gi] is None:
                z._bufs[gi] = torch.zeros(fg.padded, dtype=torch.float32, device=p.device)
            leaf = fg.leaves[li]
            z._bufs[gi][leaf.offset:leaf.offset + leaf.numel].view(leaf.shape).copy_(p.grad)
            p.grad = None
            z._pending[gi] -= 1
            if z._pending[gi] == 0:
                z._reduce_group(gi)

        return hook

    def _reduce_group(self, gi: int) -> None:
        """Sum group ``gi``'s buffer over the ranks into this rank's
        gradient shard: the shard's running sum goes into this rank's slice
        of the buffer first, so the reduce-scatter writes the new sum in
        place and no shard-sized temporary is allocated."""
        fg, shard = self.groups[gi], self.grad_shards[gi]
        fg.shard_of(self._bufs[gi], self.rank).add_(shard)
        comm.reduce_scatter_tensor(shard, self._bufs[gi], group=self.group)
        self._bufs[gi] = None
        self._pending[gi] = len(fg.leaves)

    def finish_backward(self) -> None:
        """After each microbatch's backward: stage 2 reduces a group some of
        whose leaves the loss did not reach (every rank alike); stage 3
        drops the group the backward gathered last."""
        self._regathered = None
        if self.stage == 2:
            for gi, fg in enumerate(self.groups):
                if self._pending[gi] != len(fg.leaves):
                    self._reduce_group(gi)

    def reduce_grads(self, gas: int) -> List[torch.Tensor]:
        """End of the step's backward passes: stages 0-1 sum the gradients
        over the ranks; every stage divides by ``gas * world``. Returns
        :meth:`grads`."""
        if self.stage <= 1:
            for g in self.grad_flats:
                comm.all_reduce(g, group=self.group)
            torch._foreach_div_(self.grad_flats, float(gas * self.world))
        else:
            torch._foreach_div_(self._flat_grads(), float(gas * self.world))
        experts = [p.grad for p in self.experts]
        if experts:  # whole on their owner: the exchange or the reduce-scatter summed them
            torch._foreach_div_(experts, float(gas * self.world))
        return self.grads()

    def after_update(self) -> None:
        """Stages 1-2: every rank's updated shards back into the full
        parameters."""
        if self.stage in (1, 2):
            for fg, flat in zip(self.groups, self.flats):
                comm.all_gather_into_tensor(flat, fg.shard_of(flat, self.rank), group=self.group)

    def gather(self, gi: int, whole_experts: bool = False) -> Dict[Any, torch.Tensor]:
        """Group ``gi``'s leaves for a forward, {key: tensor}: gathered at
        stage 3, the model's parameters at stages 0-2; its expert-parallel
        leaves as this rank's experts, or ``whole_experts`` gathered
        (:class:`GatherExperts`)."""
        fg = self.groups[gi]
        if self.stage == 3:
            outs = GatherGroup.apply(self.shards[gi], fg, self.compute_dtype, self.group,
                                     lambda: self._drop_regathered(gi))
            for l, t in zip(fg.leaves, outs):
                self._track(t._base, gi, int(l.low and self.compute_dtype != torch.float32))
        else:
            outs = self.leaf_params[gi]
        tree = {l.key: t for l, t in zip(fg.leaves, outs)}
        owned = self.expert_leaves[gi]
        if owned and whole_experts:
            key = ("experts", gi)
            outs = GatherExperts.apply(self.compute_dtype, self.group,
                                       lambda: self._drop_regathered(key), *[p for _, p in owned])
            for j, t in enumerate(outs):
                self._track(t, key, j)
            tree.update({k: t for (k, _), t in zip(owned, outs)})
        else:
            tree.update(owned)
        return tree

    def _track(self, buf, key, bi: int) -> None:
        """Note a gathered buffer (index ``bi`` of what :meth:`_regather`
        returns for ``key``) while the forward runs."""
        self._live[buf.untyped_storage().data_ptr()] = (weakref.ref(buf), key, bi)

    def _regather(self, key) -> List[torch.Tensor]:
        """The buffers of a gather again: group ``key``'s (stage 3), or
        ``("experts", gi)``'s, each expert leaf whole."""
        if isinstance(key, tuple):
            return [_gathered_expert(p.detach(), self.compute_dtype, self.group)
                    for _, p in self.expert_leaves[key[1]]]
        return _gathered(self.shards[key].detach(), self.groups[key], self.compute_dtype,
                         self.group)

    @contextlib.contextmanager
    def regather_in_backward(self):
        """A gathering forward runs inside: a tensor autograd saves that lies
        in a gathered buffer (a stage-3 group's, or a block's whole experts)
        is saved as (its gather, buffer, size, stride, offset), and the
        backward gathers it again where it unpacks the first such tensor
        (one gather at a time, every rank in the same order, the graph being
        the same on every rank)."""
        with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
            try:
                yield
            finally:
                self._live.clear()

    def _pack(self, t):
        entry = self._live.get(t.untyped_storage().data_ptr())
        buf = entry[0]() if entry else None
        if buf is None or buf.dtype != t.dtype:
            return t
        return entry[1], entry[2], t.size(), t.stride(), t.storage_offset()

    def _drop_regathered(self, key) -> None:
        if self._regathered is not None and self._regathered[0] == key:
            self._regathered = None

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        key, bi, size, stride, offset = packed
        if self._regathered is None or self._regathered[0] != key:
            self._regathered = None
            self._regathered = (key, self._regather(key))
        return self._regathered[1][bi].as_strided(size, stride, offset)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def full_params(self) -> List[Tuple[nn.Parameter, torch.Tensor]]:
        """(model parameter, its full fp32 value: a copy) for every leaf, at
        any stage (stage 3 gathers each group)."""
        out = []
        for gi, (fg, ps) in enumerate(zip(self.groups, self.leaf_params)):
            if self.stage == 3:
                flat = self.shards[gi].detach().new_empty(fg.padded)
                comm.all_gather_into_tensor(flat, self.shards[gi].detach(), group=self.group)
            else:
                flat = self.flats[gi]
            out.extend((p, v.clone()) for p, v in zip(ps, fg.views(flat)))
        out.extend((p, _gathered_expert(p.detach(), torch.float32, self.group))
                   for p in self.experts)
        return out

    def resident_bytes(self) -> Dict[str, int]:
        """Bytes this rank holds of parameters and gradients (fp32 buffers
        and shards; the owned experts apart, as ``expert_params`` and
        ``expert_grads``; the optimizer's moments are the engine's to
        count)."""
        params = self.shards if self.stage == 3 else self.flats
        grads = self.grad_flats if self.stage <= 1 else self._flat_grads()
        out = {"params": sum(4 * t.numel() for t in params),
               "grads": sum(4 * t.numel() for t in grads)}
        if self.experts:
            out["expert_params"] = sum(4 * p.numel() for p in self.experts)
            out["expert_grads"] = sum(4 * p.grad.numel() for p in self.experts)
        return out
