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
the fp16-only overflow count (``engine.py:1405``) and the loss logged at
``steps_per_print`` boundaries. The state (step, loss scale, good steps,
the optimizer's counter and moments) lives on the device.

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
without a graph. Offload, 1-bit optimizers, pipelines and the prefetching
loader are not ported yet.
"""

import contextlib
import inspect
import logging
from typing import Optional

import numpy as np
import torch

from .. import comm
from ..parallel import groups
from .config import DeepSpeedConfig
from .constants import ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER
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
        groups.initialize_mesh(config.tpu_config.mesh_config(), self.device.type)
        self.dp_world_size = groups.get_data_parallel_world_size()
        self.dp_rank = groups.get_data_parallel_rank()
        self.mp_world_size = groups.get_model_parallel_world_size()
        self.mp_rank = groups.get_model_parallel_rank()
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
            self._zero = ZeroPartition(model, self._params, config.zero_optimization_stage,
                                       groups.get_data_parallel_group(), cast,
                                       model_group=groups.get_model_parallel_group())
            self._opt_params = self._zero.optimizer_params()
        if self._zero is not None:
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
        self.optimizer = self._configure_optimizer(optimizer)
        self._pallas_adam = self._configure_pallas_adam(optimizer)
        self.state = self._init_state()

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
                    f"fused_adam={self._pallas_adam is not None}")

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
        return build_optimizer(self.config.optimizer_name, self._opt_params, params, lr=lr)

    def _configure_pallas_adam(self, client_optimizer):
        """Engage the fused AdamW kernel (``engine.py:545``) when the config
        maps to Adam/AdamW on fp32 masters and ``tpu.pallas_fused_adam`` is
        ``"always"`` (``"auto"`` resolves to off, as in the JAX package).
        On engage, ``self.optimizer`` becomes the ``FusedAdam`` that holds
        ``FusedAdamState``. Returns the kernel's hyperparameters or None."""
        mode = self.config.tpu_config.pallas_fused_adam
        if mode == "never" or client_optimizer is not None:
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

    def _scan_microbatch_grads(self, batches, loss_scale, gas: int):
        """Sum the microbatches' gradients into zeroed fp32 ``.grad`` buffers
        (at world size >= 2 each microbatch's ``ce * weight + aux``, the aux
        term, a mean over this rank's rows, weighing 1: every rank has as
        many rows), then divide by gas (``_scan_microbatch_grads``,
        ``engine.py:811``). Returns :meth:`_step_grads`."""
        self._zero_grads()
        weights = self._loss_weights(batches, gas) if self._zero is not None else [None] * gas
        losses = []
        for i in range(gas):
            loss = self._microbatch_loss({k: v[i] for k, v in batches.items()}, i, weights[i])
            self._microbatch_backward(loss, loss_scale)
            losses.append(loss.detach())
        return self._step_grads(losses, gas)

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
        if self.fp16_enabled:
            torch._foreach_mul_(grads, 1.0 / st["loss_scale"])
            gnorm = self._grad_norm(grads)
        else:  # the loss scale is 1: the gradients are already un-scaled
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

    def _finalize_step(self, grads, mean_loss):
        """Apply the update, advance the scalars, build the step metrics
        (``engine.py:1201``)."""
        st = self.state
        gnorm_scaled = self._grad_norm(grads)
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
        if batch is None:
            assert data_iter is not None, "train_batch needs a batch or a data_iter"
            host = self._host_prepare_batch(mbs=[next(data_iter) for _ in range(gas)])
        else:
            host = self._host_prepare_batch(batch=batch)
        placed = {k: self._to_device(v) for k, v in host.items()}
        grads, mean_loss = self._scan_microbatch_grads(placed, self.state["loss_scale"], gas)
        self.micro_steps += gas
        return self._end_step(grads, mean_loss)

    def _end_step(self, grads, mean_loss):
        """The update and the step's counters and metrics; returns the
        step's mean loss."""
        metrics = self._finalize_step(grads, mean_loss)
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.fp16_enabled and bool(metrics["overflow"]):
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
        mb = {k: self._to_device(v) for k, v in
              (batch if isinstance(batch, dict) else {"input_ids": batch}).items()}
        i = self.micro_steps % self.config.gradient_accumulation_steps
        if not self._train_mode:
            with torch.no_grad():
                return self._microbatch_loss(mb, i)
        weight = None
        if self._zero is not None:
            weight = self._loss_weights({k: v[None] for k, v in mb.items()}, 1)[0]
        return self._microbatch_loss(mb, i, weight)

    __call__ = forward

    def backward(self, loss, retain_graph=False):
        """Add the gradients of ``loss`` (a :meth:`forward`'s) times the
        loss scale into the gradient buffers, zeroed at a step's first
        microbatch; ``micro_steps += 1``. Returns ``loss``."""
        if self.micro_steps % self.config.gradient_accumulation_steps == 0:
            self._zero_grads()
            self._eager_losses = []
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
        return {names[id(p)]: full[id(p)] for p in self._params}

    def zero_resident_bytes(self):
        """Bytes this rank holds of fp32 parameters, gradients and Adam
        moments (the model's parameters and ``.grad`` at world size 1); the
        expert-parallel experts apart (``expert_params``, ``expert_grads``,
        ``expert_moments``)."""
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
