"""``deepspeed.comm`` for the PyTorch port.

Counterpart of ``deepspeed_tpu/comm/comm.py``: ``init_distributed`` and the
process-group queries, and the collectives the ZeRO engine and the
expert-parallel MoE issue (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``broadcast``, ``scatter``,
``all_to_all_single``), ``p2p_exchange`` (the pipeline's sends and
receives between neighbouring stages) and ``inference_all_reduce``
(``functional.py``), the tensor-parallel regions' sum. In the JAX package these collectives are inserted by XLA
from sharding annotations; here they are explicit calls on the default
process group (or ``group``).

Backends: NCCL for CUDA tensors, gloo for CPU tensors. gloo's CUDA support
is partial, so under gloo a CUDA tensor is copied to the host around the
collective (two ranks sharing one card, where NCCL refuses a second rank).
Under NCCL nothing is staged or switched, and a failed collective raises.
Every collective runs on the process group: none turns into a local no-op.
"""

import os

import torch
import torch.distributed as dist

from .backend import TorchBackend

__all__ = ["ReduceOp", "all_gather", "all_gather_into_tensor", "all_gather_object", "all_reduce",
           "all_to_all_single",
           "barrier", "broadcast", "broadcast_object_list", "destroy_process_group", "get_backend",
           "get_global_rank", "get_local_rank", "get_rank", "get_world_size",
           "inference_all_reduce", "init_distributed",
           "is_initialized", "new_group", "p2p_exchange", "reduce_scatter_tensor", "scatter"]

ReduceOp = dist.ReduceOp
cdb = None  # the TorchBackend once init_distributed ran


def init_distributed(dist_backend=None,
                     auto_mpi_discovery=True,
                     distributed_port=29500,
                     verbose=True,
                     timeout=None,
                     init_method=None,
                     dist_init_required=None,
                     config=None,
                     rank=-1,
                     world_size=-1):
    """Initialise ``torch.distributed`` (reference ``comm.py:393``).
    ``dist_backend``: ``"nccl"`` / ``"gloo"``; default NCCL when CUDA is
    available, else gloo. ``rank`` / ``world_size``: default the
    environment's ``RANK`` / ``WORLD_SIZE`` (``torchrun``). An already
    initialised process group is taken as it is. ``dist_init_required=
    False`` initialises nothing. ``auto_mpi_discovery``, ``distributed_port``
    and ``config`` are accepted for the reference's signature; MPI rank
    discovery is not ported."""
    global cdb
    if cdb is not None and cdb.is_initialized() and dist.is_initialized():
        return cdb
    if dist_init_required is False and not dist.is_initialized():
        return None
    backend = dist_backend or ("nccl" if torch.cuda.is_available() else "gloo")
    cdb = TorchBackend(backend, init_method=init_method, rank=rank, world_size=world_size,
                       timeout=timeout)
    if verbose and cdb.world_rank == 0:
        print(f"[deepspeed_tpu_torch.comm] initialized {dist.get_backend()} rank "
              f"{cdb.world_rank} of {cdb.world_size}", flush=True)
    return cdb


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def get_global_rank(group=None, group_rank: int = 0) -> int:
    """The world rank of ``group``'s rank ``group_rank``."""
    if group is None or not is_initialized():
        return group_rank
    return dist.get_global_rank(group, group_rank)


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def get_backend(group=None) -> str:
    return dist.get_backend(group)


def barrier(group=None):
    dist.barrier(group=group)


def new_group(ranks=None):
    return dist.new_group(ranks=ranks)


def destroy_process_group(group=None):
    global cdb
    if group is not None:
        dist.destroy_process_group(group)
        return
    if cdb is not None:
        cdb.destroy_process_group()
    elif dist.is_initialized():
        dist.destroy_process_group()
    cdb = None


def all_gather_object(object_list, obj, group=None):
    """``object_list`` (of world size) <- every rank's picklable ``obj``."""
    dist.all_gather_object(object_list, obj, group=group)
    return object_list


def broadcast_object_list(object_list, src=0, group=None):
    dist.broadcast_object_list(object_list, src=src, group=group)
    return object_list


def _staged(group, tensors):
    """Whether ``tensors`` go through host copies: CUDA tensors under gloo."""
    return any(t.is_cuda for t in tensors) and dist.get_backend(group) == "gloo"


def all_reduce(tensor, op=ReduceOp.SUM, group=None):
    """In place over ``group`` (default: the world)."""
    if _staged(group, [tensor]):
        host = tensor.cpu()
        dist.all_reduce(host, op=op, group=group)
        tensor.copy_(host)
        return tensor
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


def all_gather_into_tensor(output, input, group=None):
    """``output`` ([world * n]) <- every rank's ``input`` ([n]) in rank
    order. ``input`` may be this rank's slice of ``output`` (in place)."""
    if _staged(group, [output, input]):
        host = torch.empty(output.shape, dtype=output.dtype)
        dist.all_gather_into_tensor(host, input.cpu(), group=group)
        output.copy_(host)
        return output
    dist.all_gather_into_tensor(output, input, group=group)
    return output


def reduce_scatter_tensor(output, input, op=ReduceOp.SUM, group=None):
    """``output`` ([n]) <- this rank's slice of ``input`` ([world * n])
    reduced over ``group``."""
    if _staged(group, [output, input]):
        host = torch.empty(output.shape, dtype=output.dtype)
        dist.reduce_scatter_tensor(host, input.cpu(), op=op, group=group)
        output.copy_(host)
        return output
    dist.reduce_scatter_tensor(output, input, op=op, group=group)
    return output


def broadcast(tensor, src=0, group=None):
    if _staged(group, [tensor]):
        host = tensor.cpu()
        dist.broadcast(host, src=src, group=group)
        tensor.copy_(host)
        return tensor
    dist.broadcast(tensor, src=src, group=group)
    return tensor


def scatter(tensor, scatter_list=None, src=0, group=None):
    """``tensor`` <- chunk ``rank`` of ``scatter_list`` (one tensor a rank,
    given on the world rank ``src`` only)."""
    if _staged(group, [tensor]):
        host = torch.empty(tensor.shape, dtype=tensor.dtype)
        dist.scatter(host, [t.cpu() for t in scatter_list] if scatter_list else None, src=src,
                     group=group)
        tensor.copy_(host)
        return tensor
    dist.scatter(tensor, scatter_list, src=src, group=group)
    return tensor


def all_to_all_single(output, input, group=None):
    """``input`` split into ``world`` equal chunks along dim 0, chunk j sent
    to rank j; ``output`` (``input``'s shape) <- the chunks received, in
    rank order."""
    if _staged(group, [output, input]):
        host = torch.empty(output.shape, dtype=output.dtype)
        dist.all_to_all_single(host, input.cpu(), group=group)
        output.copy_(host)
        return output
    dist.all_to_all_single(output, input, group=group)
    return output


def p2p_exchange(ops):
    """Point-to-point sends and receives issued together and waited on:
    ``ops`` is a list of ``(is_send, tensor, peer)``, ``peer`` a world rank;
    a received tensor is filled in place. Issued as one
    ``batch_isend_irecv``, so two ranks that each send to the other before
    receiving do not wait on each other (NCCL runs a batch as one group)."""
    if not ops:
        return
    staged = _staged(None, [t for _, t, _ in ops])
    bufs = [(t.cpu() if send else torch.empty(t.shape, dtype=t.dtype)) if staged else t
            for send, t, _ in ops]
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend if send else dist.irecv, buf, peer)
                                   for (send, _, peer), buf in zip(ops, bufs)])
    for req in reqs:
        req.wait()
    if staged:
        for (send, t, _), buf in zip(ops, bufs):
            if not send:
                t.copy_(buf)


from .functional import all_gather, inference_all_reduce  # noqa: E402
