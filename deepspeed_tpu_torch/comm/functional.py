"""The collectives of tensor parallelism, over a process group.

Counterpart of ``deepspeed_tpu/comm/functional.py``, whose functions are
``lax`` collectives over mesh axis names inside ``shard_map``; here they are
``comm`` calls over a ``torch.distributed`` process group (the model group
of ``parallel.groups``), staged through the host under gloo as every
collective of ``comm`` is. ``module_inject/layers.py``'s column and row
regions issue them.
"""

import torch

from .comm import ReduceOp, all_gather_into_tensor, all_reduce, get_world_size


def inference_all_reduce(tensor, op=ReduceOp.SUM, group=None):
    """The tensor-parallel partial sums combined (reference ``comm.py:499``):
    ``tensor`` reduced over ``group`` in place. Returns it."""
    return all_reduce(tensor, op=op, group=group)


def all_gather(tensor, group=None, dim: int = 0):
    """Every rank's ``tensor`` concatenated along ``dim`` in rank order (the
    reference's ``all_gather(..., tiled=True)``): a new tensor, ``world``
    times ``tensor``'s size along ``dim``."""
    world = get_world_size(group)
    out = tensor.new_empty((world, *tensor.shape))
    all_gather_into_tensor(out.view(world * tensor.numel()), tensor.contiguous().view(-1),
                           group=group)
    return torch.cat(out.unbind(0), dim=dim)
