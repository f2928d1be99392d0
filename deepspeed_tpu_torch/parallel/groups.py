"""Parallel group registry.

Counterpart of ``deepspeed_tpu/parallel/groups.py`` (the reference's
``deepspeed/utils/groups.py``). In the JAX package a group is a tuple of
mesh axis names; here it is the ``torch.distributed`` process group of a
``DeviceMesh`` axis, which the collectives of ``comm`` take as ``group``.
Only ``data`` is ported: the model, pipe and sequence getters report size
1. The expert getters follow the reference (``groups.py:123-164``): the
expert-parallel and expert-data-parallel groups are the data group, the
expert-parallel size is the mesh's ``expert`` and the expert-data size
``data // expert``. Before ``initialize_mesh`` (or at world size 1) every
size is 1 and every group None.
"""

from typing import Optional

from .. import comm
from .mesh import DATA_AXIS, MeshConfig, build_mesh

_WORLD_MESH = None
_EXPERT_PARALLEL_SIZE = 1


def initialize_mesh(mesh_config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """Build the world mesh over the initialised process group (analog of
    ``groups.initialize``); at world size 1 there is none. Returns it."""
    global _WORLD_MESH, _EXPERT_PARALLEL_SIZE
    world = comm.get_world_size()
    config = mesh_config or MeshConfig()
    if world == 1:
        config.resolve(1)
        _WORLD_MESH, _EXPERT_PARALLEL_SIZE = None, 1
        return None
    _WORLD_MESH = build_mesh(config, world, device_type)
    _EXPERT_PARALLEL_SIZE = max(1, config.expert)
    return _WORLD_MESH


def get_mesh():
    return _WORLD_MESH


def get_data_parallel_group():
    return _WORLD_MESH.get_group(DATA_AXIS) if _WORLD_MESH is not None else None


def get_data_parallel_world_size() -> int:
    return _WORLD_MESH.size(0) if _WORLD_MESH is not None else 1


def get_data_parallel_rank() -> int:
    return _WORLD_MESH.get_local_rank(DATA_AXIS) if _WORLD_MESH is not None else 0


def get_model_parallel_world_size() -> int:
    return 1


def get_pipe_parallel_world_size() -> int:
    return 1


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

