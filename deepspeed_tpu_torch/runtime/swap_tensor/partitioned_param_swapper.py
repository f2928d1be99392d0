"""Parameters on NVMe.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/partitioned_param_swapper.py``
(the reference's ``AsyncPartitionedParameterSwapper``): host copies of
parameters kept in files, one a key, swapped in on demand with the reads
and writes overlapped. The engine's ``offload_param`` is not ported
(ROADMAP A6.6); this swapper serves code that keeps tensors on the disk.
"""

import os
from typing import Dict, List, Optional

import torch

from ...ops.aio import AsyncIOHandle
from .async_swapper import as_host_tensor


class AsyncPartitionedParameterSwapper:

    def __init__(self, base_dir: str, aio_handle: Optional[AsyncIOHandle] = None,
                 buffer_count: int = 5):
        self.base_dir = os.path.join(base_dir, "zero_stage_3", "params")
        os.makedirs(self.base_dir, exist_ok=True)
        self.handle = aio_handle or AsyncIOHandle()
        self.buffer_count = buffer_count
        self._meta: Dict[str, tuple] = {}  # key -> (shape, dtype), once swapped out
        self._pending_reads: Dict[str, torch.Tensor] = {}
        self._pending_writes: List[torch.Tensor] = []

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_").replace(".", "_")
        return os.path.join(self.base_dir, f"{safe}.param")

    def available_params(self):
        return set(self._meta)

    def swap_out(self, key: str, tensor, async_op: bool = True):
        t = as_host_tensor(tensor)
        self._meta[key] = (tuple(t.shape), t.dtype)
        self.handle.async_pwrite(t, self._path(key))
        self._pending_writes.append(t)
        if not async_op:
            self.synchronize_writes()

    def swap_in(self, key: str, async_op: bool = True) -> Optional[torch.Tensor]:
        """Start reading ``key``; with ``async_op`` collect it with
        :meth:`retrieve` after :meth:`synchronize_reads`."""
        if key not in self._meta:
            raise KeyError(f"parameter {key} was never swapped out")
        shape, dtype = self._meta[key]
        buf = torch.empty(shape, dtype=dtype)
        self.handle.async_pread(buf, self._path(key))
        self._pending_reads[key] = buf
        if async_op:
            return None
        self.synchronize_reads()
        return self._pending_reads.pop(key)

    def retrieve(self, key: str) -> torch.Tensor:
        return self._pending_reads.pop(key)

    def synchronize_reads(self):
        self.handle.wait()

    def synchronize_writes(self):
        self.handle.wait()
        self._pending_writes.clear()

    def remove(self, key: str):
        self._meta.pop(key, None)
        try:
            os.unlink(self._path(key))
        except OSError:
            pass
