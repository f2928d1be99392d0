"""Parallel group registry.

Counterpart of ``deepspeed_tpu/parallel/groups.py`` (the reference's
``deepspeed/utils/groups.py``). In the JAX package a group is a tuple of
mesh axis names; here it is the ``torch.distributed`` process group of a
``DeviceMesh`` axis, which the collectives of ``comm`` take as ``group``.
Only ``data`` is ported: the model, pipe, sequence and expert getters
report size 1 and rank 0. Before ``initialize_mesh`` (or at world size 1)
every size is 1 and every group None.
"""

from typing import Optional

from .. import comm
from .mesh import DATA_AXIS, MeshConfig, build_mesh

_WORLD_MESH = None


def initialize_mesh(mesh_config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """Build the world mesh over the initialised process group (analog of
    ``groups.initialize``); at world size 1 there is none. Returns it."""
    global _WORLD_MESH
    world = comm.get_world_size()
    config = mesh_config or MeshConfig()
    if world == 1:
        config.resolve(1)
        _WORLD_MESH = None
        return None
    _WORLD_MESH = build_mesh(config, world, device_type)
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


def get_expert_parallel_world_size(group_name: str = "default") -> int:
    return 1

