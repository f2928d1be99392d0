"""Pipeline schedules.

Counterpart of ``deepspeed_tpu/runtime/pipe/schedule.py`` (the reference's
``deepspeed/runtime/pipe/schedule.py``): ``PipeSchedule`` yields one list of
instructions per step, ``TrainSchedule`` (1F1B), ``InferenceSchedule``,
``DataParallelSchedule`` and the instruction classes, with the same
instruction streams. The JAX package compiles its pipeline into one XLA
program and keeps these for reasoning about it; the port's executor
(``runtime/pipe/engine.py``) walks them, one process a stage, as the
reference's ``PipelineEngine._exec_schedule`` does.

``FillDrainSchedule`` is the port's: the GPipe stream of the ``pipeline``
config's ``schedule: "gpipe"`` (every forward, then every backward), laid
out in the same global steps as ``TrainSchedule``: a stage's send and its
neighbour's receive of the same tensor fall in the same step.
"""

from abc import ABC, abstractmethod


class PipeInstruction:
    """Base instruction (reference :327)."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        if self.kwargs:
            args = ", ".join(f"{k}={v}" for k, v in sorted(self.kwargs.items()))
            return f"{self.name}({args})"
        return self.name


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class BufferOpInstruction(PipeInstruction):

    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


class PipeSchedule(ABC):
    """Reference :11 — yields lists of instructions per step."""

    def __init__(self, micro_batches, stages, stage_id):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = self.stage_id - 1
        self.next_stage = self.stage_id + 1

    @abstractmethod
    def steps(self):
        ...

    def num_pipe_buffers(self):
        return self.micro_batches

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, micro_batch_id):
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        self.it = None
        return self

    def __next__(self):
        if self.it is None:
            self.it = self.steps()
        return next(self.it)


class InferenceSchedule(PipeSchedule):
    """Reference :135 — forward-only pipelining."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds = []
            micro_batch_id = step_id - self.stage_id
            if self._valid_micro_batch(micro_batch_id):
                if self.is_first_stage or self.is_last_stage:
                    cmds.append(LoadMicroBatch(self._buffer_idx(micro_batch_id)))
                if not self.is_first_stage:
                    cmds.append(RecvActivation(self._buffer_idx(micro_batch_id)))
            if self._valid_micro_batch(micro_batch_id):
                cmds.append(ForwardPass(self._buffer_idx(micro_batch_id)))
                if not self.is_last_stage:
                    # send happens after compute in the same step
                    cmds.append(SendActivation(self._buffer_idx(micro_batch_id)))
            yield cmds

    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """Reference :189 — 1F1B: steady state alternates one forward with one
    backward, bounding live activations to ~num_stages microbatches."""

    def steps(self):
        prev_micro_batch_id = -1
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)
            cmds = []

            # exchange activations/grads
            if self._valid_micro_batch(prev_micro_batch_id):
                if is_forward:
                    if self._valid_stage(self.prev_stage):
                        cmds.append(SendGrad(self._buffer_idx(prev_micro_batch_id)))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(SendActivation(self._buffer_idx(prev_micro_batch_id)))
            if self._valid_micro_batch(micro_batch_id):
                if is_forward:
                    if self._valid_stage(self.prev_stage):
                        cmds.append(RecvActivation(self._buffer_idx(micro_batch_id)))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(RecvGrad(self._buffer_idx(micro_batch_id)))

            # load and compute
            if self._valid_micro_batch(micro_batch_id):
                if is_forward:
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(self._buffer_idx(micro_batch_id)))
                    cmds.append(ForwardPass(self._buffer_idx(micro_batch_id)))
                else:
                    cmds.append(BackwardPass(self._buffer_idx(micro_batch_id)))

            # model step at the end
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_micro_batch_id = micro_batch_id
            yield cmds

    def _step_to_micro_batch(self, step_id):
        """Reference mapping of global step -> (micro_batch, is_forward)."""
        if _is_even(step_id) and _is_even(self.stage_id):
            micro_batch_id = self._even_step_forward_id(step_id)
            is_forward = True
        elif _is_odd(step_id) and _is_odd(self.stage_id):
            micro_batch_id = self._odd_step_forward_id(step_id)
            is_forward = True
        elif _is_even(step_id) and _is_odd(self.stage_id):
            micro_batch_id = self._even_step_backward_id(step_id)
            is_forward = False
        elif _is_odd(step_id) and _is_even(self.stage_id):
            micro_batch_id = self._odd_step_backward_id(step_id)
            is_forward = False
        else:
            raise AssertionError("unreachable")
        return micro_batch_id, is_forward

    def _even_step_forward_id(self, step_id):
        base = step_id // 2
        return int(base - self.stage_id // 2)

    def _odd_step_forward_id(self, step_id):
        base = (step_id - 1) // 2
        return int(base - self.stage_id // 2)

    def _even_step_backward_id(self, step_id):
        base = step_id // 2
        return int(base - self.stages + (self.stage_id + 1) // 2)

    def _odd_step_backward_id(self, step_id):
        base = ((step_id - 1) // 2) - self.stages + 1
        return int(base + self.stage_id // 2)

    def num_pipe_buffers(self):
        """1F1B needs stages - stage_id live buffers (reference :289)."""
        buffers = min(self.stages - self.stage_id, self.micro_batches)
        return max(2, buffers)


class DataParallelSchedule(PipeSchedule):
    """Reference trailing class — degenerate single-stage schedule."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [LoadMicroBatch(0), ForwardPass(0), BackwardPass(0)]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1


class FillDrainSchedule(PipeSchedule):
    """GPipe's fill-drain stream: the forward of microbatch m at stage s in
    step ``m + s``, then, after all ``M + S - 1`` forward steps, its backward
    in step ``M + S - 1 + m + (S - 1 - s)``. Each step first sends what the
    stage's previous step produced and receives what this step consumes, as
    ``TrainSchedule``'s steps do. Every microbatch keeps its own buffer
    (its boundary activation is alive until its backward)."""

    def steps(self):
        prev_micro_batch_id, prev_forward = -1, True
        fill = self.micro_batches + self.stages - 1
        total_steps = 2 * fill
        for step_id in range(total_steps):
            is_forward = step_id < fill
            if is_forward:
                micro_batch_id = step_id - self.stage_id
            else:
                micro_batch_id = step_id - fill - (self.stages - 1 - self.stage_id)
            cmds = []
            if self._valid_micro_batch(prev_micro_batch_id):
                if prev_forward and self._valid_stage(self.next_stage):
                    cmds.append(SendActivation(self._buffer_idx(prev_micro_batch_id)))
                if not prev_forward and self._valid_stage(self.prev_stage):
                    cmds.append(SendGrad(self._buffer_idx(prev_micro_batch_id)))
            if self._valid_micro_batch(micro_batch_id):
                if is_forward:
                    if self._valid_stage(self.prev_stage):
                        cmds.append(RecvActivation(self._buffer_idx(micro_batch_id)))
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(self._buffer_idx(micro_batch_id)))
                    cmds.append(ForwardPass(self._buffer_idx(micro_batch_id)))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(RecvGrad(self._buffer_idx(micro_batch_id)))
                    cmds.append(BackwardPass(self._buffer_idx(micro_batch_id)))
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())
            prev_micro_batch_id, prev_forward = micro_batch_id, is_forward
            yield cmds


def _is_even(x):
    return x % 2 == 0


def _is_odd(x):
    return x % 2 != 0
