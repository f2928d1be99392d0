"""The device mesh of the PyTorch port.

Counterpart of ``deepspeed_tpu/parallel/mesh.py``: the same axis names and
``MeshConfig.resolve`` (sizes of ``-1`` absorb the remaining ranks). The
JAX package builds one ``jax.sharding.Mesh`` whose axes XLA lowers to
collectives; here the mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group, one rank a device.

The port shards over ``data`` (data parallelism and ZeRO; a MoE model's
experts shard over the same group), ``model`` (tensor parallelism: the
Megatron column / row splits of ``module_inject``) and ``pipe`` (pipeline
stages, ``runtime/pipe/engine.py``). The axes follow the reference's
``AXIS_ORDER``, ``pipe`` outermost and ``model`` innermost: rank ``(p * data
+ d) * model + m`` is pipe index p, data index d and model index m, so the
ranks of a model group are neighbours (``parallel/topology.py``'s
``PipeModelDataParallelTopology`` numbers them alike). ``pipe`` with
``model`` above 1 is refused (ROADMAP A6.8, left open: pipe × model).
``expert`` is the reference's expert parallel size: it must
divide ``data * seq`` (``resolve``), and the port takes 1 or ``data * seq``
only, the two layouts its partition builds (``refuse_expert_data_replicas``).
Every other axis above 1 raises, naming the ROADMAP item that ports it.
"""

import os
from dataclasses import dataclass

import numpy as np

DATA_AXIS = "data"
DATA_REPL_AXIS = "data_repl"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"

# the axes the port does not shard over yet, and the ROADMAP item of each
UNPORTED_AXES = {
    SEQ_AXIS: "sequence parallelism (ROADMAP A8)",
    DATA_REPL_AXIS: "MiCS replica groups (ROADMAP A2, left open)",
}


def refuse_unported_axes(sizes: dict) -> None:
    """Raise for any axis of ``sizes`` other than ``data``, ``model``,
    ``pipe`` and ``expert`` above 1, and for ``pipe`` and ``model`` both
    above 1."""
    for axis, item in UNPORTED_AXES.items():
        n = int(sizes.get(axis, 1))
        if n > 1:
            raise NotImplementedError(f"mesh axis '{axis}' of size {n}: {item} is not ported to "
                                      f"the PyTorch package yet; it shards over 'data', 'model' "
                                      f"and 'pipe' only")
    pipe, model = int(sizes.get(PIPE_AXIS, 1)), int(sizes.get(MODEL_AXIS, 1))
    if pipe > 1 and model > 1:
        raise NotImplementedError(f"mesh 'pipe' {pipe} with 'model' {model}: ROADMAP A6.8, left "
                                  f"open: pipe × model (3D parallelism) is not ported to the "
                                  f"PyTorch package yet")


def refuse_expert_data_replicas(expert: int, data: int) -> None:
    """The partition shards a MoE model's experts over the whole data group
    (``E / data`` a rank) or, where ``data`` does not divide ``E``,
    replicates them: an ``expert`` size between 1 and ``data`` (experts
    replicated over ``data / expert`` expert-data ranks) raises.
    ``data``: the resolved ``data * seq``."""
    if expert not in (1, data):
        raise NotImplementedError(
            f"mesh axis 'expert' of size {expert} with 'data' {data}: expert-data replicas "
            f"(ROADMAP A3, left open) are not ported to the PyTorch package yet; 'expert' "
            f"must be 1 or the data size")


@dataclass
class MeshConfig:
    """Axis sizes of the mesh (the ``tpu.mesh`` block of the JSON config)."""

    data: int = -1
    data_repl: int = 1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> dict:
        sizes = {PIPE_AXIS: self.pipe, DATA_REPL_AXIS: self.data_repl, DATA_AXIS: self.data,
                 SEQ_AXIS: self.seq, MODEL_AXIS: self.model}
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
        known = int(np.prod([v for v in sizes.values() if v != -1]))
        if unknown:
            if n_devices % known != 0:
                raise ValueError(f"device count {n_devices} not divisible by fixed axes "
                                 f"product {known}")
            sizes[unknown[0]] = n_devices // known
        total = int(np.prod(list(sizes.values())))
        if total != n_devices:
            raise ValueError(f"mesh axes {sizes} product {total} != device count {n_devices}")
        dp_sp = sizes[DATA_AXIS] * sizes[SEQ_AXIS]
        if self.expert not in (1, ) and dp_sp % self.expert != 0:
            raise ValueError(f"expert parallel size {self.expert} must divide data*seq ({dp_sp})")
        return sizes


def build_mesh(config: MeshConfig, world_size: int, device_type: str):
    """A ``DeviceMesh`` over the ``world_size`` ranks of the default process
    group, after resolving ``config`` against ``world_size`` and refusing
    every other axis above 1 and expert-data replicas: the axis ``data``
    (alone, it reuses the default group as its group), with ``pipe`` before
    it and ``model`` after it where they are above 1; rank ``d * model + m``
    at ``[d, m]``, rank ``p * data + d`` at ``[p, d]``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    sizes = config.resolve(world_size)
    refuse_unported_axes(sizes)
    refuse_expert_data_replicas(config.expert, sizes[DATA_AXIS] * sizes[SEQ_AXIS])
    if device_type == "cuda" and not torch.cuda.is_initialized():
        # a DeviceMesh binds a process with no CUDA context yet to
        # cuda:LOCAL_RANK; gloo ranks sharing a card bind to LOCAL_RANK modulo
        # the cards, as comm's backend binds NCCL ranks
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        torch.cuda.init()
    names = [a for a in (PIPE_AXIS, DATA_AXIS, MODEL_AXIS) if a == DATA_AXIS or sizes[a] > 1]
    if names == [DATA_AXIS]:
        return DeviceMesh(device_type, list(range(world_size)), mesh_dim_names=(DATA_AXIS, ))
    ranks = torch.arange(world_size).reshape(*[sizes[a] for a in names])
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))
