"""The pipeline executor: one process a stage, walking its instruction stream.

The JAX package compiles a pipeline's whole fill / drain loop into one XLA
program (``deepspeed_tpu/runtime/pipe/spmd.py``). The port runs the
reference DeepSpeed design instead (``runtime/pipe/engine.py``'s
``PipelineEngine._exec_schedule``): each rank of the ``pipe`` mesh axis is
one stage, holds only its stage's parameters (``model.pipeline_stage``) and
runs the instructions of ``TrainSchedule`` (1F1B, ``pipeline.schedule:
"1f1b"``) or ``FillDrainSchedule`` (GPipe, ``"gpipe"``) eagerly:

- ``ForwardPass``: the stage on its next microbatch; the last stage's output
  is the microbatch's cross entropy.
- ``BackwardPass``: at the last stage the backward of ``(ce * weight + aux)
  * loss_scale``, elsewhere ``torch.autograd.backward`` of the stage's output
  with the gradient received (and of its MoE aux term times the loss scale);
  the received input's gradient is kept for ``SendGrad``.
- ``Send/RecvActivation``, ``Send/RecvGrad``: the step's sends and receives
  to the stage's neighbours in the same data index, issued together
  (``comm.p2p_exchange``) and waited on before the compute of the step.
  Both schedules place a send and its receive in the same step.
- ``ReduceTiedGrads``: the tied embedding's gradient summed over the first
  and last stage. ``ReduceGrads``: the ZeRO partition over the stage's data
  group (stages 0-1) sums the stage's gradients, or, at data size 1, they
  are divided by the microbatch count. ``OptimizerStep``: the engine's
  update, whose gradient norm (:meth:`PipelineExecutor.grad_norm`) sums the
  stages' square sums, the tied embedding once.

``train`` returns the JAX formula's loss on every rank: the mean over
microbatches of each microbatch's cross entropy (its masked mean with a
``loss_mask``, over the global microbatch at data size above 1), plus the
MoE aux terms summed over the stages, over the microbatch count.
"""

import torch

from ... import comm
from ...parallel import groups
from ...parallel.topology import PipeDataParallelTopology
from .schedule import (BackwardPass, FillDrainSchedule, ForwardPass, LoadMicroBatch,
                       OptimizerStep, RecvActivation, RecvGrad, ReduceGrads, ReduceTiedGrads,
                       SendActivation, SendGrad, TrainSchedule)

_P2P = (SendActivation, SendGrad, RecvActivation, RecvGrad)


class PipelineExecutor:
    """This rank's stage of the engine's pipeline. Building it takes the
    stage (``model.pipeline_stage(stage, stages)``): every parameter of the
    model outside the stage is frozen and freed. A model that holds one
    stage only (``TransformerLM(..., pipe_stage=...)``) must hold this
    rank's."""

    def __init__(self, engine, model, schedule: str = "1f1b"):
        self.engine = engine
        self.stage_id = groups.get_pipe_parallel_rank()
        self.num_stages = groups.get_pipe_parallel_world_size()
        self.group = groups.get_pipe_parallel_group()
        self.schedule = schedule
        held = getattr(model, "pipe_stage", None)
        if held is not None and held != (self.stage_id, self.num_stages):
            raise ValueError(f"the model holds pipeline stage {held[0]} of {held[1]}; this rank "
                             f"is stage {self.stage_id} of {self.num_stages}")
        self.stage = model.pipeline_stage(self.stage_id, self.num_stages)
        self.first, self.last = self.stage.first, self.stage.last
        mine = {id(p) for _, p in self.stage.named_parameters()}
        # each parameter's whole shape and its first owning stage, the same on every rank
        self.shapes = self.stage.whole_shapes()
        self.owner, tied = {}, False
        for s in range(self.num_stages):
            other = model.pipeline_stage(s, self.num_stages)
            tied |= bool(other.tied)
            for n, _ in other.named_parameters():
                self.owner.setdefault(n, s)
        with torch.no_grad():
            for _, p in model.named_parameters():
                if id(p) not in mine:
                    p.requires_grad_(False)
                    p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.prev = (comm.get_global_rank(self.group, self.stage_id - 1)
                     if not self.first else None)
        self.next = comm.get_global_rank(self.group, self.stage_id + 1) if not self.last else None
        self.tied_group = self._tied_group() if tied else None  # made on every rank
        self.skip_norm = []  # per optimizer gradient: a copy of the tied embedding (last stage)
        self.max_live = 0  # the most microbatches whose activations were alive at once
        # a first collective over the world before any point-to-point
        # operation (NCCL's batched sends need the ranks' communicator)
        comm.all_reduce(torch.zeros(1, device=engine.device))

    def _tied_group(self):
        """The process group of the first and last stage of this rank's
        pipeline, None on a stage between them (every rank makes every
        pipeline's group, in order)."""
        topo = PipeDataParallelTopology(self.num_stages, comm.get_world_size() // self.num_stages)
        mine = None
        for ranks in topo.get_axis_comm_lists("pipe"):
            g = comm.new_group([ranks[0], ranks[-1]])
            if comm.get_rank() in (ranks[0], ranks[-1]):
                mine = g
        return mine

    def bind_norm(self, zero):
        """Mark the optimizer gradients that hold the tied embedding on the
        last stage (counted once in the norm, on the first stage)."""
        tied = {id(p) for p in self.stage.tied} if self.last else set()
        if zero is None:
            self.skip_norm = [id(p) in tied for p in self.engine._params]
        else:
            self.skip_norm = [any(id(p) in tied for p in ps) for ps in zero.leaf_params]
            self.skip_norm += [False] * len(zero.experts)

    def grad_norm(self, grads):
        """The whole model's gradient norm (a device scalar, equal on every
        rank): this rank's square sums, the tied copy skipped, summed over
        the world where the gradients are ZeRO shards (stage 1), else over
        the pipe group."""
        counted = [g for g, skip in zip(grads, self.skip_norm) if not skip]
        local = (torch.stack(torch._foreach_norm(counted)).square().sum() if counted else
                 torch.zeros((), device=self.engine.device))
        z = self.engine._zero
        return comm.all_reduce(local, group=None if z is not None and z.sharded_grads
                               else self.group).sqrt()

    # ------------------------------------------------------------------
    # a step
    # ------------------------------------------------------------------
    def train(self, batches, loss_scale, gas: int):
        """One step's forward and backward passes over ``gas`` microbatches
        (``batches``: {key: [gas, micro, ...]} on the device, this rank's
        rows), the tied and data-parallel reductions. Returns (the
        optimizer's gradients, the step's loss)."""
        eng = self.engine
        eng._zero_grads()
        self.batches, self.loss_scale = batches, loss_scale
        self.weights = None
        if self.last and eng._zero is not None and "loss_mask" in batches:
            self.weights = eng._loss_weights(batches, gas)
        self.live, self.inputs, self.grads_in, self.grads_out = {}, {}, {}, {}
        self.next_fwd, self.max_live = 0, 0
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=eng.device)
        cls = TrainSchedule if self.schedule == "1f1b" else FillDrainSchedule
        for cmds in cls(gas, self.num_stages, self.stage_id):
            self._exchange([c for c in cmds if isinstance(c, _P2P)])
            for cmd in cmds:
                if not isinstance(cmd, _P2P):
                    self._run(cmd)
        if self.live or self.grads_out:
            raise RuntimeError("the schedule left microbatches unfinished")
        if eng._zero is not None:
            grads = eng._zero.reduce_grads(gas)
        else:
            for p in eng._params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in eng._params]
            torch._foreach_div_(grads, float(gas))
        total = comm.all_reduce(self.loss_sum)  # the last stages' CE, every stage's aux
        return grads, total / (gas * eng.dp_world_size)

    def _run(self, cmd):
        if isinstance(cmd, ForwardPass):
            self._forward(cmd.buffer_id)
        elif isinstance(cmd, BackwardPass):
            self._backward(cmd.buffer_id)
        elif isinstance(cmd, ReduceTiedGrads):
            for p in self.stage.tied:
                comm.all_reduce(p.grad, group=self.tied_group)
        elif not isinstance(cmd, (LoadMicroBatch, ReduceGrads, OptimizerStep)):
            raise NotImplementedError(f"pipeline instruction {cmd!r}")

    def _exchange(self, cmds):
        """The step's sends and receives, together; a received activation
        becomes the stage's input (a leaf whose gradient is sent back)."""
        if not cmds:
            return
        ops, recv = [], []
        for c in cmds:
            buf = c.buffer_id
            if isinstance(c, SendActivation):
                ops.append((True, self.live[buf][1].detach(), self.next))
            elif isinstance(c, SendGrad):
                ops.append((True, self.grads_out.pop(buf), self.prev))
            else:
                mb = self.next_fwd if isinstance(c, RecvActivation) else self.live[buf][0]
                shape, dtype = self.stage.activation(
                    {k: v[mb] for k, v in self.batches.items()})
                t = torch.empty(shape, dtype=dtype, device=self.engine.device)
                ops.append((False, t, self.prev if isinstance(c, RecvActivation) else self.next))
                recv.append((c, t))
        comm.p2p_exchange(ops)
        for c, t in recv:
            if isinstance(c, RecvActivation):
                self.inputs[c.buffer_id] = t.requires_grad_()
            else:
                self.grads_in[c.buffer_id] = t

    def _forward(self, buf):
        mb = self.next_fwd
        self.next_fwd += 1
        if buf in self.live:
            raise RuntimeError(f"pipeline buffer {buf} is still alive at microbatch {mb}")
        batch = {k: v[mb] for k, v in self.batches.items()}
        out, aux = self.stage.forward(batch["input_ids"] if self.first else self.inputs[buf],
                                      batch)
        self.live[buf] = (mb, out, aux)
        self.max_live = max(self.max_live, len(self.live))
        with torch.no_grad():
            if self.last:
                self.loss_sum += out if self.weights is None else out * self.weights[mb]
            if aux is not None:
                self.loss_sum += aux

    def _backward(self, buf):
        mb, out, aux = self.live.pop(buf)
        if self.last:
            loss = out if self.weights is None else out * self.weights[mb]
            if aux is not None:
                loss = loss + aux
            (loss * self.loss_scale).backward()
        else:
            outs, grads = [out], [self.grads_in.pop(buf)]
            if aux is not None:
                outs.append(aux * self.loss_scale)
                grads.append(None)
            torch.autograd.backward(outs, grads)
        if not self.first:
            self.grads_out[buf] = self.inputs.pop(buf).grad
        if self.engine._zero is not None:
            self.engine._zero.finish_backward()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def gather_state_dict(self, own):
        """{name: full fp32 value} of every parameter of the model on every
        rank: ``own`` (this stage's {name: value}) for its own, the others
        broadcast from their first owning stage over the pipe group."""
        out = {}
        for name, shape in self.shapes.items():
            src = self.owner[name]
            t = own[name] if src == self.stage_id else torch.empty(
                shape, dtype=torch.float32, device=self.engine.device)
            out[name] = comm.broadcast(t, src=comm.get_global_rank(self.group, src),
                                       group=self.group)
        return out
