"""Parallel group registry.

Counterpart of ``deepspeed_tpu/parallel/groups.py`` (the reference's
``deepspeed/utils/groups.py``). In the JAX package a group is a tuple of
mesh axis names; here it is the ``torch.distributed`` process group of a
``DeviceMesh`` axis, which the collectives of ``comm`` take as ``group``.
``data``, ``model`` and ``pipe`` are ported (``groups.py:105,111,145``):
the data group of a rank is the ranks that share its pipe and model
indices, the model group the ranks that share its pipe and data indices,
the pipe group (a rank's pipeline, one rank a stage) the ranks that share
its data and model indices; the sequence getter reports size 1. The
expert getters follow the reference (``groups.py:123-164``): the
expert-parallel and expert-data-parallel groups are the data group, the
expert-parallel size is the mesh's ``expert`` and the expert-data size
``data // expert``. Before ``initialize_mesh`` (or at world size 1) every
size is 1 and every group None.
"""

from typing import Optional

import torch.distributed as dist

from .. import comm
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, MeshConfig, build_mesh

_WORLD_MESH = None
_EXPERT_PARALLEL_SIZE = 1
_MESH_KEY = None  # (axis sizes, device type, default process group) of _WORLD_MESH


def initialize_mesh(mesh_config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """Build the world mesh over the initialised process group (analog of
    ``groups.initialize``); at world size 1 there is none. A mesh of the same
    axis sizes over the same process group is kept, not built again (a
    two-axis mesh makes a process group per row and column). Returns it."""
    global _WORLD_MESH, _EXPERT_PARALLEL_SIZE, _MESH_KEY
    world = comm.get_world_size()
    config = mesh_config or MeshConfig()
    if world == 1:
        config.resolve(1)
        _WORLD_MESH, _EXPERT_PARALLEL_SIZE, _MESH_KEY = None, 1, None
        return None
    key = (tuple(sorted(config.resolve(world).items())), device_type, dist.group.WORLD)
    if _MESH_KEY is None or _MESH_KEY[:2] != key[:2] or _MESH_KEY[2] is not key[2]:
        _WORLD_MESH = build_mesh(config, world, device_type)
        _MESH_KEY = key
    _EXPERT_PARALLEL_SIZE = max(1, config.expert)
    return _WORLD_MESH


def get_mesh():
    return _WORLD_MESH


def _has_axis(name: str) -> bool:
    return _WORLD_MESH is not None and name in (_WORLD_MESH.mesh_dim_names or ())


def _axis_size(name: str) -> int:
    return _WORLD_MESH.size(_WORLD_MESH.mesh_dim_names.index(name)) if _has_axis(name) else 1


def get_data_parallel_group():
    """The ranks that share this rank's pipe and model indices."""
    return _WORLD_MESH.get_group(DATA_AXIS) if _WORLD_MESH is not None else None


def get_data_parallel_world_size() -> int:
    return _axis_size(DATA_AXIS)


def get_data_parallel_rank() -> int:
    return _WORLD_MESH.get_local_rank(DATA_AXIS) if _WORLD_MESH is not None else 0


def get_model_parallel_group():
    """The ranks that share this rank's data index: the tensor-parallel
    ranks, whose collectives the column / row regions issue. None at model
    size 1."""
    return _WORLD_MESH.get_group(MODEL_AXIS) if _has_axis(MODEL_AXIS) else None


def get_model_parallel_world_size() -> int:
    return _axis_size(MODEL_AXIS)


def get_model_parallel_rank() -> int:
    return _WORLD_MESH.get_local_rank(MODEL_AXIS) if _has_axis(MODEL_AXIS) else 0


def get_pipe_parallel_group():
    """This rank's pipeline: the ranks that share its data and model
    indices, stage i at group rank i. None at pipe size 1."""
    return _WORLD_MESH.get_group(PIPE_AXIS) if _has_axis(PIPE_AXIS) else None


def get_pipe_parallel_world_size() -> int:
    return _axis_size(PIPE_AXIS)


def get_pipe_parallel_rank() -> int:
    """This rank's stage."""
    return _WORLD_MESH.get_local_rank(PIPE_AXIS) if _has_axis(PIPE_AXIS) else 0


def get_sequence_parallel_world_size() -> int:
    return 1


def get_expert_parallel_group(group_name: str = "default"):
    """The group the experts shard over and the all-to-all of token slots
    runs over: the data group."""
    return get_data_parallel_group()


def get_expert_data_parallel_group(group_name: str = "default"):
    return get_data_parallel_group()


def get_expert_parallel_world_size(group_name: str = "default") -> int:
    return _EXPERT_PARALLEL_SIZE


def get_expert_data_parallel_world_size(group_name: str = "default") -> int:
    return max(1, get_data_parallel_world_size() // _EXPERT_PARALLEL_SIZE)


def get_expert_parallel_rank(group_name: str = "default") -> int:
    """This rank's place in :func:`get_expert_parallel_group`."""
    return get_data_parallel_rank()


def get_expert_data_parallel_rank(group_name: str = "default") -> int:
    """This rank's place in :func:`get_expert_data_parallel_group`."""
    return get_data_parallel_rank()

