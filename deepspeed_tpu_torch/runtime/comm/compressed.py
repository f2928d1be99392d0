"""Compressed gradient collectives.

Counterpart of ``deepspeed_tpu/runtime/comm/compressed.py`` (the reference's
``runtime/comm/nccl.py:51`` ``NcclBackend.compressed_allreduce``, the 1-bit
Adam / Lamb error-feedback exchange, and
``runtime/comm/coalesced_collectives.py``'s ``reduce_scatter_coalesced``).
The JAX package runs these inside ``shard_map`` over a mesh axis; here they
are ``torch.distributed`` collectives over a process group (``comm``, which
stages CUDA tensors through the host under gloo). The payloads are
bit-packed uint8 signs plus one fp32 scale a chunk, so the exchange moves
about n / 4 bytes a rank where the exact mean moves 4n.

Algorithm, the JAX package's formulas and order of operations:

  worker:  c = g + err_w;  scale_w = mean|c| per destination chunk;
           err_w' = c - scale_w * sign(c);  all_to_all(sign(c), scale_w)
  server:  avg = mean_i scale_w_i * sign_i;  c_s = avg + err_s;
           scale_s = mean|c_s|;  err_s' = c_s - scale_s * sign(c_s);
           all_gather(sign(c_s), scale_s)

with ``sign(x)`` = +1 where ``x >= 0``, else -1, and ``c`` padded with
zeros to ``chunk * world`` elements (``onebit_chunk_len``).
"""

import math
from typing import Tuple

import torch

from ... import comm

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)  # bit i of a byte is element i of its 8 (LSB first)


def pack_signs(bits: torch.Tensor) -> torch.Tensor:
    """A {0, 1} tensor whose last dim is a multiple of 8 -> uint8, 8 signs a
    byte, element i of each 8 in bit i."""
    *lead, n = bits.shape
    assert n % 8 == 0, f"last dim {n} must be a multiple of 8"
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (bits.reshape(*lead, n // 8, 8).to(torch.uint8) * w).sum(dim=-1, dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8 -> a +-1 fp32 tensor with the last dim 8x longer."""
    *lead, nb = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*lead, nb * 8).float() * 2.0 - 1.0


def onebit_chunk_len(n: int, world: int) -> int:
    """Each rank's server chunk: ceil(n / world) rounded up to 8."""
    chunk = -(-n // world)
    return -(-chunk // 8) * 8


def onebit_allreduce(x: torch.Tensor, err_worker: torch.Tensor, err_server: torch.Tensor,
                     group=None, world: int = None) -> Tuple[torch.Tensor, torch.Tensor,
                                                            torch.Tensor]:
    """Error-feedback 1-bit averaged allreduce of ``x`` over ``group``.

    ``x`` and ``err_worker``: the same number of elements (any shapes);
    ``err_server``: ``(onebit_chunk_len(n, world),)``. ``world``: the
    group's size (default ``comm.get_world_size(group)``); at 1 no
    collective runs. Returns (the approximate mean, ``x``'s shape; the new
    ``err_worker``; the new ``err_server``), equal on every rank for the
    first, this rank's for the others."""
    world = comm.get_world_size(group) if world is None else world
    shape = x.shape
    n = math.prod(shape) if shape else 1
    chunk = onebit_chunk_len(n, world)
    total = chunk * world

    flat = x.reshape(-1).float() + err_worker.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, total - n))
    rows = flat.view(world, chunk)  # row j goes to rank j

    scale_w = rows.abs().mean(dim=1)  # (world,)
    bits_w = (rows >= 0).to(torch.uint8)
    signs_w = bits_w.float() * 2.0 - 1.0
    new_err_w = (rows - scale_w[:, None] * signs_w).reshape(-1)[:n].reshape(err_worker.shape)

    packed_w = pack_signs(bits_w)  # (world, chunk // 8)
    if world > 1:
        recv_packed = comm.all_to_all_single(torch.empty_like(packed_w), packed_w, group=group)
        recv_scale = comm.all_to_all_single(torch.empty_like(scale_w), scale_w, group=group)
    else:
        recv_packed, recv_scale = packed_w, scale_w
    recv_signs = unpack_signs(recv_packed)  # (world, chunk): row i from rank i

    server_avg = (recv_scale[:, None] * recv_signs).mean(dim=0)  # (chunk,)
    comp_s = server_avg + err_server.float()
    scale_s = comp_s.abs().mean()
    bits_s = (comp_s >= 0).to(torch.uint8)
    signs_s = bits_s.float() * 2.0 - 1.0
    new_err_s = comp_s - scale_s * signs_s

    packed_s = pack_signs(bits_s[None, :])[0]  # (chunk // 8,)
    if world > 1:
        all_packed = comm.all_gather_into_tensor(
            packed_s.new_empty(world * packed_s.numel()), packed_s, group=group)
        all_scale = comm.all_gather_into_tensor(scale_s.new_empty(world), scale_s.reshape(1),
                                                group=group)
    else:
        all_packed, all_scale = packed_s, scale_s.reshape(1)
    out_rows = all_scale[:, None] * unpack_signs(all_packed.view(world, -1))  # (world, chunk)
    out = out_rows.reshape(-1)[:n].reshape(shape)
    return out, new_err_w.to(err_worker.dtype), new_err_s.to(err_server.dtype)


def onebit_wire_bytes(n: int, world: int) -> int:
    """Bytes one rank sends in :func:`onebit_allreduce` of ``n`` elements:
    the packed signs and scales of its all-to-all (less its own chunk) and
    of its all-gather (its chunk to every other rank)."""
    chunk = onebit_chunk_len(n, world)
    return 2 * (world - 1) * (chunk // 8 + 4)


def reduce_scatter_coalesced(tensors, group=None):
    """The reference's ``reduce_scatter_coalesced:73``: each tensor's MEAN
    over ``group``, this rank's slice of its dim 0 (which the group's size
    must divide), one reduce-scatter a tensor."""
    world = comm.get_world_size(group)
    out = []
    for t in tensors:
        assert t.shape[0] % world == 0, f"dim 0 of {tuple(t.shape)} is not a multiple of {world}"
        part = t.new_empty((t.shape[0] // world, *t.shape[1:]))
        comm.reduce_scatter_tensor(part, (t / world).contiguous(), group=group)
        out.append(part)
    return out


def all_to_all_quant_reduce(tensors, group=None, block_size: int = 256):
    """The reference's qgZ ``all_to_all_quant_reduce:31``: an int8
    block-quantized reduction, which needs ``ops/pallas/quant.py``'s
    ``quantized_psum_scatter`` (ROADMAP A8)."""
    raise NotImplementedError("all_to_all_quant_reduce (int8 block-quantized gradient "
                              "reduction) is not ported to the PyTorch package yet: it needs "
                              "the quantized collectives of ROADMAP A8")
