"""DeepSpeedEngine for the PyTorch port: the training slice.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` for the path
``initialize`` -> ``train_batch``, with the JAX formulas kept:

- ``train_batch`` splits the batch gas-major (``engine.py:1245``), runs one
  forward and backward per microbatch on ``loss * loss_scale``, sums the
  gradients into the fp32 ``.grad`` of the fp32 masters and divides the sum
  by gas (``_scan_microbatch_grads``, ``engine.py:811``: the same order).
- ``_apply_update`` (``engine.py:742``): un-scale, overflow detection on the
  gradient global norm, optax's ``clip_by_global_norm``, the optimizer
  update, all gated on the device by the finiteness flag.
- ``_apply_update_pallas`` (``engine.py:778``, ``tpu.pallas_fused_adam:
  "always"``): one fused AdamW kernel launch with the loss un-scaling and
  the clip coefficient ``min(1, clip / (gnorm + 1e-6))`` folded into its
  gradient scale and the overflow skip into its gate.
- the dynamic loss scale (``_advance_loss_scale``, ``engine.py:729``).

A model whose ``loss`` takes a ``generator`` (a MoE ``TransformerLM``) gets
one ``torch.Generator`` a batch row, on the model's device: row ``g`` of
the step's global batch (gas-major, ``micro * dp`` rows a microbatch)
draws from a generator seeded from (the engine's seed, the step, g) alone,
as the JAX engine splits its step rng over the global rows
(``transformer.py:581-582``), so sampled routing does not depend on the
world size. The draws stay on the device.

Nothing inside ``train_batch`` reads a device value back to the host, except
the fp16-only overflow count (``engine.py:1405``), the loss logged at
``steps_per_print`` boundaries and, under a 1-bit optimizer, one flag a step
(below). The state (step, loss scale, good steps, the optimizer's counter
and moments) lives on the device.

Data parallelism (``engine.py:70-215``): under ``torchrun`` (or after
``init_distributed``) the data-parallel world is the ``data`` axis of
``parallel.groups``, and each rank's ``train_batch`` takes its own
``gas * micro`` rows, as upstream DeepSpeed's does: rank r's rows of a
microbatch are rows ``[r * micro, (r + 1) * micro)`` of the JAX engine's
global microbatch of ``micro * dp`` rows. ZeRO stages 0-3 then partition
over the ranks (``zero/partition.py``): gradients summed over the ranks
(``all_reduce``, or ``reduce_scatter`` into shards at stages 2-3), the
optimizer, the fused AdamW kernel included, on each rank's shards at
stages >= 1, the global gradient norm one ``all_reduce`` of the shards'
partial sums. The loss is the reference's over the global microbatch: each
rank weights its local cross-entropy mean by ``local_count * dp /
global_count`` (the model's ``loss_count``; 1 without a ``loss_mask``) and
its MoE aux term (a mean over its rows, which are as many on every rank)
by 1 (the model's ``_loss_terms``). A MoE model's experts shard over the
ranks where the world divides their count (``zero/partition.py``). At world
size 1 nothing of this runs: no collective, no copy. The hybrid engine is
refused at world size >= 2.

Tensor parallelism (``"tpu": {"mesh": {"data": D, "model": M}}``, the
reference's ``engine.py:170``): ``dp_world_size`` / ``dp_rank`` are the data
axis's and ``mp_world_size`` / ``mp_rank`` the model axis's. The model
becomes this rank's shards (``TransformerLM.shard_tensor_parallel``, rank
0's weights), every rank of a model group takes the same rows (those of
its data rank), and ZeRO partitions each rank's shards over its data group
(none where D is 1). The gradient norm is the whole logical model's: the
split parameters' square sums add over the model group, a replicated one's
counts once (on model rank 0). ``module_state_dict`` gathers the whole,
unsplit tree on every rank.

The eager API (``engine.py:1597-1729``): ``forward(batch)`` (and
``engine(batch)``) takes this rank's microbatch ``i = micro_steps % gas``
and returns its loss with its graph, ``backward(loss)`` adds its gradients
(``micro_steps += 1``), ``step()`` applies the update at the accumulation
boundary and is a no-op elsewhere. They run the per-microbatch code of
``train_batch`` (``_microbatch_loss``, ``_microbatch_backward``,
``_step_grads``, ``_end_step``), so eager steps equal ``train_batch`` steps
on the same data. In ``eval()`` mode ``forward`` returns this rank's loss
without a graph.

ZeRO-Offload (``zero_optimization.offload_optimizer``, ``engine.py:589-640,
880-940``): the card runs the forward and backward; the update runs on the
host in the C++ Adam of ``zero/offload.py`` over fp32 masters and moments in
host RAM (``device: cpu``) or with the moments on NVMe (``device: nvme``),
and the new masters are uploaded into the parameters. The gradient norm is
computed on the card and read once; the lr is the schedule's at the step
before the update; a non-finite norm skips the update. Any optimizer name
other than Adam / AdamW runs as the host AdamW, with a warning. Twin-flow
(``ratio`` < 1, Adam / AdamW only): the host takes whole JAX leaves (a
``TransformerLM``'s per-layer tensors of one stacked leaf together, so the
split is the JAX engine's) up to ``ratio`` of the bytes; the rest update on
the card with the port's ``Adam``, gated, launched before the host loop so
that the two overlap. The fused Adam kernel stays off under offload.
Offload at world size >= 2 is refused (the JAX package's per-host
``shard_mode``, ROADMAP A6.6, left open).

The 1-bit optimizers (``onebitadam``, ``onebitlamb``, ``zerooneadam``;
``engine.py:523-542,977-1058``), in the JAX package's envelope (ZeRO stage
<= 1, data parallelism only, no offload, no MiCS; a MoE model is refused):
each rank's gradients, summed over its microbatches, divided by gas and
un-scaled, are exchanged exactly for ``freeze_step`` steps, then JAX leaf by
JAX leaf through the error-feedback 1-bit collective
(``comm/compressed.py``), with this rank's error buffers. The path needs one
host read a step, of a flag reduced by MIN over the data group (every
rank's gradients finite): running both exchanges would throw the
compression away. A non-finite step takes the exact mean, leaves the error
buffers as they were, and is skipped by the update. The update is ``Adam``
or ``Lamb`` (the fused Adam kernel stays off); each rank's loss is its
local mean, averaged over the ranks. The eager API raises, naming
``train_batch``, as the JAX engine's does. Lamb at data-parallel world size >= 2
(ZeRO stages 0-1) takes each JAX leaf's trust ratio over the slices its
tensors occupy in the partition's buffers, summed over the data group at
stage 1.

Pipeline parallelism (``"tpu": {"mesh": {"pipe": P, "data": D}}``, the
``pipeline`` block's ``schedule``; ``engine.py:176-198``): each rank is
one stage of a ``TransformerLM`` (``model.pipeline_stage``) and runs the
1F1B or GPipe instruction stream eagerly (``pipe/engine.py``); ZeRO stages
0-1 partition each stage's parameters over its data group; the gradient
norm sums the stages' (the tied embedding once); ``module_state_dict``
gathers every stage's parameters on every rank. ZeRO >= 2, ``seq``, pipe x
model, the noisy MoE gate, Lamb, and a MoE model at data size above 1 are
refused; the eager API raises.

Not ported: the prefetching loader (A6.5).
"""

import contextlib
import inspect
import logging
import time
from typing import Optional

import numpy as np
import torch

from .. import comm
from ..models.transformer import TransformerConfig, training_attention_route
from ..parallel import groups
from .config import DeepSpeedConfig
from .constants import (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, LAMB_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER)
from .dataloader import DeepSpeedDataLoader
from .lr_schedules import LRScheduler, get_lr_schedule_fn
from .optimizers import Adam, build_optimizer
from .utils import clip_by_global_norm_, global_norm
from .zero.partition import ZeroPartition, is_model_parallel

logger = logging.getLogger("deepspeed_tpu_torch")


def _row_seed(seed: int, step: int, row: int) -> int:
    """A 64-bit seed from (seed, step, global row) alone."""
    return int(np.random.SeedSequence([seed, step, row]).generate_state(1, np.uint64)[0])


class DeepSpeedEngine:

    def __init__(self, model, config: DeepSpeedConfig, optimizer=None, lr_scheduler=None,
                 training_data=None, collate_fn=None, seed: int = 42):
        self.module = model
        self.config = config
        self.client_optimizer = optimizer
        self.training_dataloader = None
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._step_metrics = {}
        self._train_mode = True
        self._eager_losses = []  # the eager API's microbatch losses of this step

        self._params = [p for p in model.parameters() if p.requires_grad]
        if not self._params:
            raise ValueError("the model has no trainable parameters (a TransformerLM trains "
                             "with trainable=True)")
        self.device = self._params[0].device
        model_config = getattr(model, "config", None)
        if isinstance(model_config, TransformerConfig):  # refuses unbuilt flash shapes now
            training_attention_route(model_config, self.device.type)
        groups.initialize_mesh(config.tpu_config.mesh_config(), self.device.type)
        self.dp_world_size = groups.get_data_parallel_world_size()
        self.dp_rank = groups.get_data_parallel_rank()
        self.mp_world_size = groups.get_model_parallel_world_size()
        self.mp_rank = groups.get_model_parallel_rank()
        self.pipe_world_size = groups.get_pipe_parallel_world_size()
        stages = config.pipeline_config.stages
        if stages != "auto" and int(stages) != self.pipe_world_size:
            raise ValueError(f"pipeline.stages={stages!r}: the stages are the mesh's pipe axis "
                             f"({self.pipe_world_size}); set tpu.mesh.pipe, or stages 'auto'")
        self._offload_cfg = self._offload_config()
        self._onebit = self._configure_onebit(model)
        self._pipe = None
        if self.pipe_world_size > 1:
            self._pipe = self._configure_pipeline(model)
            self._params = [p for p in model.parameters() if p.requires_grad]
        if self.mp_world_size > 1:
            self._split_model(model)
        if self.dp_world_size > 1:
            self._refuse_at_world_above_one(model, optimizer)
        config.resolve_batch_config(self.dp_world_size)

        # --- precision policy (the model's config.dtype sets the compute
        #     dtype; this is the engine's view of it, as in the JAX engine) ---
        self.compute_dtype = (torch.bfloat16 if config.bfloat16_enabled else
                              (torch.float16 if config.fp16_enabled else torch.float32))
        self.fp16_enabled = config.fp16_enabled
        self.bfloat16_enabled = config.bfloat16_enabled
        self.dynamic_loss_scale = self.fp16_enabled and config.loss_scale == 0

        # ZeRO's partition at world size >= 2 (none at world size 1); the
        # optimizer updates its tensors, which are the model's parameters
        # at world size 1
        self._zero = None
        self._opt_params = self._params
        if self.dp_world_size > 1:
            # stage 3 gathers a group in the dtype the model computes in
            cast = getattr(getattr(model, "config", None), "dtype", self.compute_dtype)
            self._zero = ZeroPartition(model if self._pipe is None else self._pipe.stage,
                                       self._params, config.zero_optimization_stage,
                                       groups.get_data_parallel_group(), cast,
                                       model_group=groups.get_model_parallel_group())
            self._opt_params = self._zero.optimizer_params()
        if self._pipe is not None:
            self._pipe.bind_norm(self._zero)
            self._grad_norm = self._pipe.grad_norm
        elif self._zero is not None:
            self._grad_norm = self._zero.grad_norm
        elif self.mp_world_size > 1:
            self._grad_norm = self._model_parallel_norm
        else:
            self._grad_norm = global_norm
        # the gating's randomness (MoE): a generator a batch row, on the device
        self._loss_takes_generator = (hasattr(model, "loss") and "generator" in
                                      inspect.signature(model.loss).parameters)
        self.seed = seed

        # --- optimizer chain ---
        self.lr_schedule_fn, self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.host_optimizer = None
        self._twin_host = None  # twin-flow: per trainable parameter, whether the host updates it
        self._twin_optimizer = None
        self.offload_times = {}
        self._t_step = time.perf_counter()
        if self._offload_cfg is not None:
            self.optimizer = self._configure_host_offload_optimizer(optimizer)
        else:
            self.optimizer = self._configure_optimizer(optimizer)
        self._pallas_adam = self._configure_pallas_adam(optimizer)
        self.state = self._init_state()
        if self._onebit is not None:
            self._init_onebit_errors()

        if config.sparse_gradients_enabled:
            # accepted for config compatibility (engine.py:381-385): the
            # embedding gradient is a dense scatter-add on the device, with
            # no sparse-gradient path to switch on
            logger.info("sparse_gradients: no-op (embedding gradients are dense scatter-adds on "
                        "the device); flag accepted for config compatibility")
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data, collate_fn=collate_fn)
        logger.info(f"DeepSpeedEngine ready: zero_stage={config.zero_optimization_stage} "
                    f"dtype={self.compute_dtype} device={self.device} "
                    f"micro_bsz={config.train_micro_batch_size_per_gpu} "
                    f"gas={config.gradient_accumulation_steps} "
                    f"fused_adam={self._pallas_adam is not None} "
                    f"offload={self._offload_cfg.device if self._offload_cfg else None}")

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def _split_model(self, model):
        """Model size >= 2: the model becomes this rank's tensor-parallel
        shards (a model built with this plan's shards stays as it is)."""
        if not hasattr(model, "shard_tensor_parallel"):
            raise NotImplementedError(
                f"tensor parallelism (mesh 'model' {self.mp_world_size}) splits the model's "
                f"weights: the model needs shard_tensor_parallel() (a TransformerLM has it)")
        from ..models.transformer import tensor_parallel

        model.shard_tensor_parallel(tensor_parallel(model.config,
                                                    groups.get_model_parallel_group()))

    def _configure_pipeline(self, model):
        """The pipe axis above 1 (``engine.py:176-198``): this rank's stage
        of ``model`` (``runtime/pipe/engine.py``), with the JAX package's
        envelope: ZeRO stage <= 1, a model with pipeline stages, the layers
        divisible by the stages (and the model's own refusals, such as the
        noisy MoE gate)."""
        from .pipe.engine import PipelineExecutor

        if self.config.zero_optimization_stage > 1:
            raise ValueError("pipeline parallelism requires ZeRO stage <= 1")
        if not hasattr(model, "pipeline_stage"):
            raise ValueError("model must provide pipeline_stage for pipeline parallelism (a "
                             "trainable TransformerLM has it)")
        name = (self.config.optimizer_name or "").lower()
        if name == LAMB_OPTIMIZER:
            raise NotImplementedError(
                "Lamb under a pipeline: a stacked JAX leaf's trust ratio spans the stages "
                "(ROADMAP A6.8, left open)")
        moe = getattr(getattr(model, "config", None), "moe_num_experts", 0) > 0
        if moe and self.dp_world_size > 1:
            raise NotImplementedError(
                "a MoE model under a pipeline at data size above 1: the stages' experts over "
                "the data group (ROADMAP A6.8, left open)")
        return PipelineExecutor(self, model, self.config.pipeline_config.schedule)

    def _model_parallel_norm(self, grads):
        """The whole model's gradient norm at model size >= 2 without a
        ZeRO partition: the split parameters' gradients on every model rank,
        the replicated ones' on model rank 0, summed over the model group."""
        counted = [g for g, p in zip(grads, self._params)
                   if self.mp_rank == 0 or is_model_parallel(p)]
        return global_norm(counted, groups.get_model_parallel_group())

    def _refuse_at_world_above_one(self, model, client_optimizer):
        """What does not train at data-parallel world size >= 2 yet, each
        naming its ROADMAP item; and every rank on one kind of device."""
        world = self.dp_world_size
        stage = self.config.zero_optimization_stage
        if client_optimizer is not None and stage >= 1:
            raise NotImplementedError(
                f"a client optimizer at ZeRO stage {stage} and world size {world}: it holds the "
                f"full parameters, not this rank's shards; use the config's optimizer block")
        if stage == 3 and not hasattr(model, "gathered_params"):
            raise NotImplementedError(
                f"ZeRO stage 3 at world size {world} gathers each group where the forward uses "
                f"it: the model needs zero_groups() and gathered_params() (TransformerLM and a "
                f"loss function with model_parameters have them)")
        if any(p.dtype != torch.float32 for p in self._params):
            raise ValueError("ZeRO at world size >= 2 partitions fp32 master parameters")
        kinds = comm.all_gather_object([None] * comm.get_world_size(), self.device.type)
        if len(set(kinds)) > 1:
            raise RuntimeError(f"the ranks' parameters live on different kinds of device: {kinds}")

    def _configure_lr_scheduler(self, client_scheduler):
        """Client scheduler wins (a ``step -> lr`` callable or an
        ``LRScheduler``), else the config's (``engine.py:494``)."""
        if client_scheduler is not None:
            if callable(client_scheduler) and not isinstance(client_scheduler, LRScheduler):
                return client_scheduler, LRScheduler(client_scheduler)
            return client_scheduler.schedule_fn, client_scheduler
        name = self.config.scheduler_name
        if name is not None:
            base_lr = (self.config.optimizer_params or {}).get("lr", 1e-3)
            fn = get_lr_schedule_fn(name, self.config.scheduler_params or {}, base_lr=base_lr)
            return fn, LRScheduler(fn)
        return None, None

    def _configure_optimizer(self, client_optimizer):
        """A client ``torch.optim.Optimizer``, or the config's (``engine.py:507``);
        clipping is the engine's, in front of it."""
        if client_optimizer is not None:
            return client_optimizer
        params = dict(self.config.optimizer_params or {})
        lr = self.lr_schedule_fn if self.lr_schedule_fn is not None else params.get("lr", 1e-3)
        groups_ = norm_group = None
        if (self.config.optimizer_name or "").lower() in (LAMB_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER):
            z = self._zero
            if self.mp_world_size > 1 or (z is not None and (z.stage >= 2 or z.experts)):
                raise NotImplementedError(
                    "Lamb under tensor parallelism, at ZeRO stage >= 2 or with expert-parallel "
                    "experts: its trust ratio needs each JAX leaf's norms over those shards "
                    "(ROADMAP A6.3, left open)")
            groups_ = self._jax_leaf_units() if z is None else self._zero_trust_groups()
            norm_group = z.group if z is not None and z.stage == 1 else None
        return build_optimizer(self.config.optimizer_name, self._opt_params, params, lr=lr,
                               trust_groups=groups_, norm_group=norm_group)

    def _zero_trust_groups(self):
        """Lamb's trust groups over the ZeRO partition's buffers (stages
        0-1): each JAX leaf (:meth:`_jax_leaf_units`) as the slices
        ``(buffer index, lo, hi)`` its tensors occupy in the full buffers
        (stage 0) or in this rank's shards of them (stage 1)."""
        z = self._zero
        place = {}  # parameter id -> (group index, offset, numel)
        for gi, (fg, ps) in enumerate(zip(z.groups, z.leaf_params)):
            for leaf, p in zip(fg.leaves, ps):
                place[id(p)] = (gi, leaf.offset, leaf.numel)
        out = []
        for unit in self._jax_leaf_units():
            entries = []
            for i in unit:
                gi, off, n = place[id(self._params[i])]
                base = 0 if z.stage == 0 else z.rank * z.groups[gi].shard
                end = z.groups[gi].padded if z.stage == 0 else base + z.groups[gi].shard
                lo, hi = max(off, base), min(off + n, end)
                if lo < hi:
                    entries.append((gi, lo - base, hi - base))
            out.append(entries)
        return out

    def _jax_leaf_units(self):
        """The trainable parameters' indices grouped as the JAX package's
        leaves, in its tree's order: a ``TransformerLM``'s per-layer tensors
        of one stacked leaf ``blocks/<name>`` form one unit, units sorted by
        (group, name) as jax flattens the dict tree; any other model's
        parameters are a unit each, in order."""
        if not hasattr(self.module, "_leaves"):  # a TransformerLM's (group, name, p, stacked)
            return [[i] for i in range(len(self._params))]
        index = {id(p): i for i, p in enumerate(self._params)}
        units = {}
        for group, name, p, _ in self.module._leaves():
            if id(p) in index:
                units.setdefault((group, name), []).append(index[id(p)])
        return [units[k] for k in sorted(units)]

    def _offload_config(self):
        """The ``offload_optimizer`` block when it offloads, else None
        (``engine.py:279-297``); refuses world size >= 2."""
        off = self.config.zero_config.offload_optimizer
        if off is None or off.device == "none":
            return None
        if off.ratio <= 0.0:
            logger.warning("offload_optimizer.ratio=0: nothing to offload; running the plain "
                           "device optimizer")
            return None
        world = self.dp_world_size * self.mp_world_size * self.pipe_world_size
        if world > 1:
            raise NotImplementedError(
                f"offload_optimizer at world size {world}: ROADMAP A6.6, left open: per-rank "
                f"shards (the JAX package's `shard_mode`)")
        return off

    def _configure_host_offload_optimizer(self, client_optimizer):
        """The host optimizer (``engine.py:589-616``): the fused CPU Adam(W)
        over the masters of every trainable parameter, or of the twin-flow
        host set, whose complement updates on the card with ``Adam``
        (``engine.py:299-320,625-640``). Returns the host optimizer."""
        from .zero.offload import HostOffloadOptimizer, partition_leaves_by_ratio

        off = self._offload_cfg
        params = dict(self.config.optimizer_params or {})
        name = (self.config.optimizer_name or ADAMW_OPTIMIZER).lower()
        adam_names = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER)
        host = [True] * len(self._params)
        if off.ratio < 1.0:
            if client_optimizer is not None or name not in adam_names:
                # the host set always runs the CPU Adam: another device rule
                # would train the two halves under different optimizers
                raise ValueError(
                    "offload_optimizer.ratio < 1 (twin-flow) requires an Adam/AdamW config "
                    f"optimizer (both slices must share the update rule); got "
                    f"{'a client optimizer object' if client_optimizer is not None else repr(name)}"
                    ". Use ratio=1.0 (full offload) or switch the optimizer.")
            units = self._jax_leaf_units()
            mask = partition_leaves_by_ratio(
                [sum(4 * self._params[i].numel() for i in u) for u in units], off.ratio)
            for unit, on_host in zip(units, mask):
                for i in unit:
                    host[i] = on_host
            self._twin_host = host
        elif client_optimizer is not None:
            logger.warning("offload_optimizer: the client optimizer is not used; the host runs "
                           "the fused CPU Adam")
        if name not in adam_names:
            logger.warning(f"offload_optimizer: '{name}' not supported on host; using fused CPU "
                           f"AdamW")
        names = {id(p): n for n, p in self.module.named_parameters()}
        host_params = [p for p, h in zip(self._params, host) if h]
        self.host_optimizer = HostOffloadOptimizer(
            host_params, lr=params.get("lr", 1e-3), betas=tuple(params.get("betas", (0.9, 0.999))),
            eps=params.get("eps", 1e-8), weight_decay=params.get("weight_decay", 0.0),
            adamw_mode=name == ADAMW_OPTIMIZER or params.get("adam_w_mode", True),
            nvme_path=off.nvme_path if off.device == "nvme" else None,
            pipeline_read=off.pipeline_read, pipeline_write=off.pipeline_write,
            grad_clip=self.config.gradient_clipping or 0.0,
            keys=[names.get(id(p), str(i)) for i, p in enumerate(host_params)],
            buffer_count=off.buffer_count)
        if self._twin_host is not None:
            lr = self.lr_schedule_fn if self.lr_schedule_fn is not None else params.get("lr", 1e-3)
            self._twin_optimizer = build_optimizer(
                name, [p for p, h in zip(self._params, host) if not h], params, lr=lr)
        n_host = sum(host)
        logger.info(f"ZeRO-Offload ({off.device}): {n_host}/{len(host)} trainable tensors' "
                    f"optimizer state on the host"
                    + (f" (twin-flow ratio {off.ratio})" if self._twin_host is not None else ""))
        return self.host_optimizer

    def _configure_onebit(self, model):
        """The 1-bit policy of an ``onebitadam`` / ``onebitlamb`` /
        ``zerooneadam`` optimizer block, or None (``engine.py:523-542``),
        with the JAX package's envelope: ZeRO stage <= 1, data parallelism
        only, no offload."""
        from .fp16.onebit import OnebitAdam, OnebitLamb, ZeroOneAdam

        name = (self.config.optimizer_name or "").lower()
        cls = {ONEBIT_ADAM_OPTIMIZER: OnebitAdam, ONEBIT_LAMB_OPTIMIZER: OnebitLamb,
               ZERO_ONE_ADAM_OPTIMIZER: ZeroOneAdam}.get(name)
        if cls is None:
            return None
        policy = cls.from_params(self.config.optimizer_params or {})
        if self.config.zero_optimization_stage > 1:
            raise ValueError("1-bit optimizers require ZeRO stage <= 1")
        if self.mp_world_size > 1 or groups.get_pipe_parallel_world_size() > 1:
            raise ValueError("1-bit optimizers support pure data parallelism only")
        if self._offload_cfg is not None:
            raise ValueError("1-bit optimizers are incompatible with offload_optimizer")
        if getattr(getattr(model, "config", None), "moe_num_experts", 0) > 0:
            raise NotImplementedError(
                "1-bit optimizers with a MoE model: the JAX package compresses the experts' "
                "gradients replicated, where the port shards the experts over the data group "
                "(ROADMAP A6.7, left open)")
        logger.info(f"1-bit optimizer '{name}': exact mean for {policy.freeze_step} warmup "
                    f"steps, then error-feedback sign compression")
        return policy

    def _init_onebit_errors(self):
        """This rank's error-feedback buffers, one pair a JAX leaf
        (``engine.py:679-686``): the worker's error of the leaf's size and
        the server's of ``onebit_chunk_len``, fp32 zeros on the device."""
        from .comm.compressed import onebit_chunk_len

        self._onebit_units = self._jax_leaf_units()
        sizes = [sum(self._params[i].numel() for i in unit) for unit in self._onebit_units]
        dev = self.device
        self.onebit_err_w = [torch.zeros(n, dtype=torch.float32, device=dev) for n in sizes]
        self.onebit_err_s = [torch.zeros(onebit_chunk_len(n, self.dp_world_size),
                                         dtype=torch.float32, device=dev) for n in sizes]
        self.onebit_compressed = None  # whether the last step took the compressed exchange

    def _configure_pallas_adam(self, client_optimizer):
        """Engage the fused AdamW kernel (``engine.py:545``) when the config
        maps to Adam/AdamW on fp32 masters and ``tpu.pallas_fused_adam`` is
        ``"always"`` (``"auto"`` resolves to off, as in the JAX package).
        On engage, ``self.optimizer`` becomes the ``FusedAdam`` that holds
        ``FusedAdamState``. Returns the kernel's hyperparameters or None."""
        mode = self.config.tpu_config.pallas_fused_adam
        if (mode == "never" or client_optimizer is not None or self.host_optimizer is not None
                or self._onebit is not None):
            return None
        name = (self.config.optimizer_name or ADAMW_OPTIMIZER).lower()
        if name not in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER):
            return None
        params = dict(self.config.optimizer_params or {})
        adam_w = name == ADAMW_OPTIMIZER or params.get("adam_w_mode", True)
        wd = params.get("weight_decay", 0.0)
        if not adam_w and wd:
            return None  # plain-Adam weight decay (grad += wd * p) is not fused
        if mode == "auto":
            return None
        if any(p.dtype != torch.float32 for p in self._opt_params):
            return None  # the kernel reads and writes fp32 state
        from ..ops.adam.fused_adam import FusedAdam

        betas = tuple(params.get("betas", (0.9, 0.999)))
        lr = self.lr_schedule_fn if self.lr_schedule_fn is not None else params.get("lr", 1e-3)
        self.optimizer = FusedAdam(self._opt_params, lr=lr, betas=betas,
                                   eps=params.get("eps", 1e-8), weight_decay=wd)
        logger.info("fused Adam step engaged (single-pass multi-tensor update, gated)")
        return {"b1": betas[0], "b2": betas[1], "eps": params.get("eps", 1e-8), "wd": wd,
                "lr": params.get("lr", 1e-3)}

    def _init_state(self):
        """The engine's scalars on the device (``engine.py:621``); params
        are the model's, the moments the optimizer's."""
        dev = self.device
        if self.fp16_enabled and self.config.loss_scale:
            scale = float(self.config.loss_scale)
        else:
            scale = float(self.config.initial_dynamic_scale) if self.fp16_enabled else 1.0
        self._n_params = sum(p.numel() for p in self._params)
        logger.info(f"training {self._n_params / 1e6:.2f}M parameters on {dev}")
        return {
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "loss_scale": torch.full((), scale, dtype=torch.float32, device=dev),
            "good_steps": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def adam_state(self):
        """(mu list, nu list, update counter) of the Adam(W) state, in the
        order of the model's trainable parameters."""
        if self._pallas_adam is not None:
            st = self.optimizer.fused_state
            return st.mu, st.nu, st.step
        if isinstance(self.optimizer, Adam):
            opt = self.optimizer
            return ([opt._init_state(p, "mu") for p in self._opt_params],
                    [opt._init_state(p, "nu") for p in self._opt_params], opt.count)
        if self.host_optimizer is not None:
            raise TypeError("under offload_optimizer the Adam state is on the host "
                            "(engine.host_optimizer.state_dict())")
        raise TypeError(f"{type(self.optimizer).__name__} holds no Adam state")

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def row_generators(self, i: int, rows: int):
        """The gating's generators of this rank's ``rows`` rows of
        microbatch ``i`` of this step: row b is row ``(i * dp + rank) *
        rows + b`` of the step's global batch, seeded from (seed, step,
        that row)."""
        first = (i * self.dp_world_size + self.dp_rank) * rows
        return [torch.Generator(device=self.device).manual_seed(
            _row_seed(self.seed, self.global_steps, first + b)) for b in range(rows)]

    def _loss_terms(self, batch, i: int):
        """(CE term, aux term) of microbatch ``i``: the model's
        ``_loss_terms`` where it has them, else (its loss, 0)."""
        m, z = self.module, self._zero
        split = hasattr(m, "_loss_terms")
        fn = m._loss_terms if split else (m.loss if hasattr(m, "loss") else m)
        kw = {}
        if self._loss_takes_generator:
            kw["generator"] = self.row_generators(i, len(next(iter(batch.values()))))
        gathers = z is not None and z.gathers(getattr(m, "gathers_experts", False))
        with z.regather_in_backward() if gathers else contextlib.nullcontext():
            if gathers:
                kw["params"] = m.gathered_params(z.gather)
            out = fn(batch, **kw)
        if split:
            return out
        return (out[0] if isinstance(out, tuple) else out), 0.0

    def _microbatch_loss(self, batch, i: int, weight=None):
        """Microbatch ``i``'s loss with its graph: ``ce + aux``, or at world
        size >= 2 ``ce * weight + aux`` (``weight`` from
        :meth:`_loss_weights`)."""
        ce, aux = self._loss_terms(batch, i)
        return ce + aux if weight is None else ce * weight + aux

    def _microbatch_backward(self, loss, loss_scale, retain_graph=False):
        """The gradients of ``loss * loss_scale`` add into ``.grad``
        (``engine.py:717``); at world size >= 2 the partition finishes the
        microbatch's backward."""
        (loss * loss_scale).backward(retain_graph=retain_graph)
        if self._zero is not None:
            self._zero.finish_backward()

    def _zero_grads(self):
        """Zero the gradient buffers (kept across steps, so their addresses
        stay fixed) before a step's first microbatch."""
        if self._zero is not None:
            self._zero.zero_grad()
            return
        grads = [p.grad for p in self._params if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)

    def _step_grads(self, losses, gas: int):
        """The end of a step's backward passes: (the optimizer's gradients,
        divided by gas, the step's mean loss). World size 1: a parameter
        the loss does not reach gets a zero gradient. Above: the partition
        sums the gradients over the ranks, and the losses are the global
        microbatches' (``_loss_weights``)."""
        if self._onebit is not None:
            return self._onebit_step_grads(losses, gas)
        if self._zero is not None:
            grads = self._zero.reduce_grads(gas)
            summed = comm.all_reduce(torch.stack(losses), group=self._zero.group)
            return grads, (summed / self.dp_world_size).mean()
        for p in self._params:
            if p.grad is None:  # a parameter the loss does not reach
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params]
        torch._foreach_div_(grads, float(gas))
        return grads, torch.stack(losses).mean()

    def _onebit_step_grads(self, losses, gas: int):
        """The 1-bit step's gradients (``_build_onebit_train_step``,
        ``engine.py:977-1058``): each rank's sum over its microbatches
        divided by gas and by the loss scale (compressed in un-scaled units:
        the error buffers persist across steps, through changes of the
        scale); then one flag, every rank's gradients finite, reduced by MIN
        over the data group and read on the host, which picks the path. At
        ``step >= freeze_step`` with every rank finite, each JAX leaf
        (:meth:`_jax_leaf_units`: a ``TransformerLM``'s per-layer tensors
        of one stacked leaf concatenated in layer order) goes through
        ``onebit_allreduce`` with its error buffers; else the exact mean,
        which leaves the error buffers as they were (a non-finite mean is
        then the update's to skip). Returns (the optimizer's gradients,
        un-scaled; the mean of the ranks' local mean losses)."""
        from .comm.compressed import onebit_allreduce

        z, world = self._zero, self.dp_world_size
        group = z.group if z is not None else None
        for p in self._params:
            if p.grad is None:  # a parameter the loss does not reach (world size 1)
                p.grad = torch.zeros_like(p)
        bufs = z.grad_flats if z is not None else [p.grad for p in self._params]
        torch._foreach_div_(bufs, gas * self.state["loss_scale"])
        flag = torch.stack([torch.isfinite(g).all() for g in bufs]).all().to(torch.int32)
        if world > 1:
            comm.all_reduce(flag, op=comm.ReduceOp.MIN, group=group)
        # the one host read of the step: choosing the path needs it, and
        # running both exchanges would throw the compression away
        step, finite = torch.stack([self.state["step"], flag]).tolist()
        self.onebit_compressed = bool(finite) and step >= self._onebit.freeze_step
        if self.onebit_compressed:
            for k, unit in enumerate(self._onebit_units):
                views = [self._params[i].grad for i in unit]
                g = torch.cat([v.reshape(-1) for v in views]) if len(views) > 1 else views[0]
                out, self.onebit_err_w[k], self.onebit_err_s[k] = onebit_allreduce(
                    g, self.onebit_err_w[k], self.onebit_err_s[k], group, world)
                for v, piece in zip(views, out.reshape(-1).split([v.numel() for v in views])):
                    v.copy_(piece.view_as(v))
        elif world > 1:
            for g in bufs:
                comm.all_reduce(g, group=group)
            torch._foreach_div_(bufs, float(world))
        mean = torch.stack(losses).mean()
        if world > 1:
            mean = comm.all_reduce(mean, group=group) / world
        return (z.grads() if z is not None else [p.grad for p in self._params]), mean

    def _scan_microbatch_grads(self, batches, loss_scale, gas: int):
        """Sum the microbatches' gradients into zeroed fp32 ``.grad`` buffers
        (at world size >= 2 each microbatch's ``ce * weight + aux``, the aux
        term, a mean over this rank's rows, weighing 1: every rank has as
        many rows), then divide by gas (``_scan_microbatch_grads``,
        ``engine.py:811``). Returns :meth:`_step_grads`."""
        self._zero_grads()
        weights = self._loss_weights(batches, gas) if self._weighs_losses else [None] * gas
        losses = []
        for i in range(gas):
            loss = self._microbatch_loss({k: v[i] for k, v in batches.items()}, i, weights[i])
            self._microbatch_backward(loss, loss_scale)
            losses.append(loss.detach())
        return self._step_grads(losses, gas)

    @property
    def _weighs_losses(self) -> bool:
        """Whether each rank's CE is weighted to its share of the global
        microbatch: at world size >= 2, except under a 1-bit optimizer,
        whose ranks each take their local mean (``engine.py:993-1003``)."""
        return self._zero is not None and self._onebit is None

    def _loss_weights(self, batches, gas: int):
        """[gas] device weights of this rank's microbatch CE terms,
        ``local_count * dp / global_count``, so that their sum over the
        ranks is dp times the CE of the global microbatch (its masked mean);
        ones where the counts are equal on every rank (no ``loss_mask``, or
        a model without ``loss_count``)."""
        if "loss_mask" not in batches or not hasattr(self.module, "loss_count"):
            return torch.ones(gas, dtype=torch.float32, device=self.device)
        counts = torch.stack([self.module.loss_count({k: v[i] for k, v in batches.items()})
                              for i in range(gas)]).float()
        total = comm.all_reduce(counts.clone(), group=self._zero.group)
        return counts * self.dp_world_size / total.clamp_min(1.0)

    def _advance_loss_scale(self, finite):
        """Dynamic loss-scale state machine, on the device."""
        st = self.state
        if self.fp16_enabled and self.dynamic_loss_scale:
            args = self.config.dynamic_loss_scale_args
            window, min_scale = args["scale_window"], args["min_scale"]
            good = torch.where(finite, st["good_steps"] + 1, torch.zeros_like(st["good_steps"]))
            scale = torch.where(finite,
                                torch.where(good >= window, st["loss_scale"] * 2.0,
                                            st["loss_scale"]),
                                torch.clamp_min(st["loss_scale"] * 0.5, min_scale))
            st["good_steps"] = torch.where(good >= window, torch.zeros_like(good), good)
            st["loss_scale"] = scale

    def _apply_update(self, grads, gnorm_scaled):
        """Un-scale, detect overflow, clip, update: gated on the device by
        the finiteness of the gradient norm. Returns the finiteness flag."""
        if self._pallas_adam is not None:
            return self._apply_update_pallas(grads, gnorm_scaled)
        st = self.state
        if self.fp16_enabled and self._onebit is None:
            torch._foreach_mul_(grads, 1.0 / st["loss_scale"])
            gnorm = self._grad_norm(grads)
        else:  # the loss scale is 1, or the 1-bit step un-scaled the gradients
            gnorm = gnorm_scaled
        finite = torch.isfinite(gnorm)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            clip_by_global_norm_(grads, float(clip), gnorm)
        if self.client_optimizer is None:
            self.optimizer.step(gate=finite)
        elif not self.fp16_enabled or bool(finite):
            # a client torch.optim optimizer takes no device gate: only fp16
            # (which reads the flag on the host anyway) can overflow-skip it
            self.optimizer.step()
        return finite

    def _apply_update_pallas(self, grads, gnorm_scaled):
        """Single-pass gated AdamW (``engine.py:778``): loss un-scaling and
        the clip coefficient fold into one gradient factor, the overflow
        skip is the kernel's gate."""
        pa = self._pallas_adam
        inv_scale = 1.0 / self.state["loss_scale"]
        gnorm = gnorm_scaled * inv_scale
        finite = torch.isfinite(gnorm)
        clip = float(self.config.gradient_clipping or 0.0)
        coef = torch.clamp(clip / (gnorm + 1e-6), max=1.0) if clip > 0 else 1.0
        count = self.optimizer.fused_state.step
        lr_t = self.lr_schedule_fn(count) if self.lr_schedule_fn is not None else pa["lr"]
        self.optimizer.apply(grads, lr_t=lr_t, grad_scale=inv_scale * coef, gate=finite)
        return finite

    def _apply_update_offload(self, grads, gnorm_scaled):
        """The host-offload update (``_host_apply_update``, ``engine.py:880-940``):
        the card's norm read once; twin-flow's card subset launched first
        (un-scale and clip folded into one factor, ``Adam`` gated); the
        host C++ Adam and the upload. Returns (the finiteness flag as a
        device tensor, the lr)."""
        st = self.state
        ready = torch.cuda.Event() if self.device.type == "cuda" else None
        if ready is not None:
            ready.record()  # the gradients are complete: the host set's copies may start
        scale = float(st["loss_scale"])
        gnorm = float(gnorm_scaled) / scale
        self.offload_times = {"to_norm_ms": 1e3 * (time.perf_counter() - self._t_step)}
        step_no = int(st["step"]) + 1
        lr = (float(self.lr_schedule_fn(step_no - 1)) if self.lr_schedule_fn is not None else
              (self.config.optimizer_params or {}).get("lr", 1e-3))
        host_grads = grads
        if self._twin_host is not None:  # a non-finite norm: the gate keeps the card's subset
            clip = self.config.gradient_clipping or 0.0
            factor = (1.0 / scale) * (clip / (gnorm + 1e-6) if clip and gnorm > clip else 1.0)
            torch._foreach_mul_([g for g, h in zip(grads, self._twin_host) if not h], factor)
            self._twin_optimizer.step(gate=torch.isfinite(gnorm_scaled))
            host_grads = [g for g, h in zip(grads, self._twin_host) if h]
        _, overflow = self.host_optimizer.step(step_no, host_grads, lr=lr, loss_scale=scale,
                                               grad_norm=gnorm, grads_ready=ready)
        self.offload_times.update(self.host_optimizer.times)
        return torch.tensor(not overflow, device=self.device), lr

    def _finalize_step(self, grads, mean_loss):
        """Apply the update, advance the scalars, build the step metrics
        (``engine.py:1201``)."""
        st = self.state
        gnorm_scaled = self._grad_norm(grads)
        if self.host_optimizer is not None:
            finite, lr = self._apply_update_offload(grads, gnorm_scaled)
        else:
            lr = (self.lr_schedule_fn(st["step"]) if self.lr_schedule_fn is not None else
                  (self.config.optimizer_params or {}).get("lr", 0.0))
            finite = self._apply_update(grads, gnorm_scaled)
        if self._zero is not None:
            self._zero.after_update()
        self._advance_loss_scale(finite)
        st["step"] = st["step"] + finite.to(torch.int32)
        return {"loss": mean_loss, "grad_norm": gnorm_scaled, "overflow": ~finite, "lr": lr}

    def _to_device(self, x):
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if self.device.type == "cuda" and t.device.type == "cpu":
            # pinned + non_blocking: a pageable copy would wait for the
            # device's queue, serialising host and device at every step
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _host_prepare_batch(self, batch=None, mbs=None):
        """``(gas, micro, ...)`` batch dict: ``mbs`` (``gas`` microbatches)
        stacked, or a whole ``gas * micro``-row batch split gas-major."""
        gas = self.config.gradient_accumulation_steps

        def as_dict(b):
            return b if isinstance(b, dict) else {"input_ids": b}

        if mbs is not None:
            mbs = [as_dict(mb) for mb in mbs]
            return {k: np.stack([np.asarray(mb[k]) for mb in mbs]) if not torch.is_tensor(mbs[0][k])
                    else torch.stack([mb[k] for mb in mbs]) for k in mbs[0]}
        return {k: v.reshape(gas, -1, *v.shape[1:]) if torch.is_tensor(v) else
                np.asarray(v).reshape(gas, -1, *np.shape(v)[1:]) for k, v in as_dict(batch).items()}

    def train_batch(self, batch=None, data_iter=None):
        """One full training step (all microbatches and the optimizer
        update). ``batch``: a dict (or the ids array) with leading dim
        ``gas * micro``, this rank's rows (gas-major: at world size dp,
        rank r's microbatch i is rows ``[r * micro, (r + 1) * micro)`` of the
        reference's global microbatch i of ``micro * dp`` rows); or
        ``data_iter`` yielding ``gas`` microbatches. Returns the mean loss of
        the global batch as a device tensor (no host read)."""
        gas = self.config.gradient_accumulation_steps
        self._t_step = time.perf_counter()
        if batch is None:
            assert data_iter is not None, "train_batch needs a batch or a data_iter"
            host = self._host_prepare_batch(mbs=[next(data_iter) for _ in range(gas)])
        else:
            host = self._host_prepare_batch(batch=batch)
        placed = {k: self._to_device(v) for k, v in host.items()}
        if self._pipe is not None:
            grads, mean_loss = self._pipe.train(placed, self.state["loss_scale"], gas)
        else:
            grads, mean_loss = self._scan_microbatch_grads(placed, self.state["loss_scale"], gas)
        self.micro_steps += gas
        return self._end_step(grads, mean_loss)

    def _end_step(self, grads, mean_loss):
        """The update and the step's counters and metrics; returns the
        step's mean loss."""
        metrics = self._finalize_step(grads, mean_loss)
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        # the host knows the offload path's overflow; elsewhere only fp16 reads it
        if (self.fp16_enabled or self.host_optimizer is not None) and bool(metrics["overflow"]):
            self.skipped_steps += 1
        self._record_metrics(metrics)
        return metrics["loss"]

    def _record_metrics(self, metrics):
        self._step_metrics = dict(metrics)
        if self.global_steps % self.config.steps_per_print == 0:
            logger.info(f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
                        f"lr={float(metrics['lr']):.3e} gnorm={float(metrics['grad_norm']):.3f}")

    # ------------------------------------------------------------------
    # the eager API (engine.py:1597-1729)
    # ------------------------------------------------------------------
    def forward(self, batch):
        """This rank's microbatch (a dict, or the ids array, of ``micro``
        rows) -> its loss, with its graph: microbatch ``i = micro_steps %
        gas`` of the step, with ``train_batch``'s generators, gathers and,
        at world size >= 2, loss weight. In ``eval()`` mode this rank's loss
        (``ce + aux``) under ``torch.no_grad()``."""
        self._refuse_eager()
        mb = {k: self._to_device(v) for k, v in
              (batch if isinstance(batch, dict) else {"input_ids": batch}).items()}
        i = self.micro_steps % self.config.gradient_accumulation_steps
        if not self._train_mode:
            with torch.no_grad():
                return self._microbatch_loss(mb, i)
        weight = None
        if self._weighs_losses:
            weight = self._loss_weights({k: v[None] for k, v in mb.items()}, 1)[0]
        return self._microbatch_loss(mb, i, weight)

    __call__ = forward

    def _refuse_eager(self):
        """The JAX engine's refusals of the eager API (``engine.py:1606-1611``)."""
        if self._pipe is not None:
            raise RuntimeError("forward/backward/step are not supported with pipeline "
                               "parallelism; use train_batch() (same contract as the reference "
                               "PipelineEngine)")
        if self._onebit is not None:
            raise RuntimeError("1-bit optimizers require the fused train_batch() path (the "
                               "compressed exchange lives inside the step)")

    def backward(self, loss, retain_graph=False):
        """Add the gradients of ``loss`` (a :meth:`forward`'s) times the
        loss scale into the gradient buffers, zeroed at a step's first
        microbatch; ``micro_steps += 1``. Returns ``loss``."""
        self._refuse_eager()
        if self.micro_steps % self.config.gradient_accumulation_steps == 0:
            self._zero_grads()
            self._eager_losses = []
            self._t_step = time.perf_counter()
        self._microbatch_backward(loss, self.state["loss_scale"], retain_graph)
        self._eager_losses.append(loss.detach())
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        """Whether the next :meth:`step` applies the update: every
        microbatch of the step has had its backward."""
        return (bool(self._eager_losses)
                and self.micro_steps % self.config.gradient_accumulation_steps == 0)

    def step(self):
        """At the accumulation boundary: divide by gas, the update (norm,
        clip, overflow gate, optimizer, the shards' all-gather, lr),
        ``global_steps += 1``. Elsewhere nothing."""
        self._refuse_eager()
        gas = self.config.gradient_accumulation_steps
        if self.micro_steps % gas != 0:
            return  # mid-accumulation
        if not self._eager_losses:
            raise RuntimeError("step() at the accumulation boundary with no backward() since the "
                               "last update")
        losses, self._eager_losses = self._eager_losses, []
        self._end_step(*self._step_grads(losses, gas))

    # torch-style mode flags (engine.py:2427-2433): forward reads them,
    # train_batch ignores them
    def eval(self):
        self._train_mode = False
        return self

    def train(self, mode=True):
        self._train_mode = bool(mode)
        return self

    # ------------------------------------------------------------------
    # introspection (reference engine getters)
    # ------------------------------------------------------------------
    def get_global_grad_norm(self):
        return self._step_metrics.get("grad_norm")

    def get_lr(self):
        if self.lr_schedule_fn is not None:
            return [float(self.lr_schedule_fn(int(self.state["step"])))]
        return [float((self.config.optimizer_params or {}).get("lr", 0.0))]

    @property
    def loss_scale(self):
        return float(self.state["loss_scale"])

    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self.config.zero_optimization_stage

    def sparse_attention_config(self):
        """The raw ``sparse_attention`` config block (feed to
        ``ops.sparse_attention.build_sparsity_config``; ``engine.py:1752``)."""
        return self.config.sparse_attention

    def get_batch_info(self):
        return (self.train_batch_size(), self.train_micro_batch_size_per_gpu(),
                self.gradient_accumulation_steps())

    def deepspeed_io(self, dataset, batch_size: Optional[int] = None, collate_fn=None):
        """A ``DeepSpeedDataLoader`` of this rank's microbatches (the
        ``data_iter`` contract of ``train_batch``): its sampler takes the
        data-parallel rank and world size of ``parallel.groups`` (the ranks
        of a model group read the same rows)."""
        return DeepSpeedDataLoader(dataset,
                                   batch_size=batch_size or self.config.train_micro_batch_size_per_gpu,
                                   collate_fn=collate_fn, drop_last=self.config.dataloader_drop_last,
                                   data_parallel_rank=self.dp_rank,
                                   data_parallel_world_size=self.dp_world_size)

    def module_state_dict(self):
        """{parameter name: its full fp32 master} of the trainable
        parameters, at any stage and world size (stage 3 gathers them; a
        tensor-parallel shard is gathered whole over the model group, on
        every rank). Copies where they are gathered, else the parameters
        themselves."""
        names = {id(p): n for n, p in self.module.named_parameters()}
        if self._zero is None:
            full = {id(p): p.detach() for p in self._params}
        else:
            full = {id(p): t for p, t in self._zero.full_params()}
        if self.mp_world_size > 1:
            group = groups.get_model_parallel_group()
            full = {id(p): comm.all_gather(full[id(p)], group, dim=p.partition_dim)
                    if is_model_parallel(p) else full[id(p)] for p in self._params}
        if self._pipe is not None:  # every stage's parameters, on every rank
            return self._pipe.gather_state_dict({names[id(p)]: full[id(p)] for p in self._params})
        return {names[id(p)]: full[id(p)] for p in self._params}

    def zero_resident_bytes(self):
        """Bytes this rank holds of fp32 parameters, gradients and Adam
        moments (the model's parameters and ``.grad`` at world size 1); the
        expert-parallel experts apart (``expert_params``, ``expert_grads``,
        ``expert_moments``)."""
        if self.host_optimizer is not None:  # the card holds the twin-flow subset's moments
            opt = self._twin_optimizer
            moments = [] if opt is None else [t for st in opt.state.values() for t in st.values()]
            return {"params": sum(4 * p.numel() for p in self._params),
                    "grads": sum(4 * p.grad.numel() for p in self._params if p.grad is not None),
                    "moments": sum(4 * t.numel() for t in moments)}
        mu, nu = self.adam_state()[:2]
        if self._zero is None:
            return {"params": sum(4 * p.numel() for p in self._params),
                    "grads": sum(4 * p.grad.numel() for p in self._params if p.grad is not None),
                    "moments": sum(4 * t.numel() for t in mu + nu)}
        n = len(self._zero.groups)
        out = {**self._zero.resident_bytes(),
               "moments": sum(4 * t.numel() for t in mu[:n] + nu[:n])}
        if self._zero.experts:
            out["expert_moments"] = sum(4 * t.numel() for t in mu[n:] + nu[n:])
        return out
