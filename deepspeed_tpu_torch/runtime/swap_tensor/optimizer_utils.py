"""Optimizer state on NVMe (ZeRO-Infinity's optimizer swap).

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/optimizer_utils.py``
(the reference's ``OptimizerSwapper`` and its partitioned / pipelined
forms). Each key's moments (``exp_avg``, ``exp_avg_sq``, fp32) live in one
file each; around the optimizer step they stream through host tensors, with
separate read and write handles so that while key i updates, key i+1's
moments are read and key i-1's are written back::

    swapper.prefetch(key)            # submit the reads
    state = swapper.fetch(key)       # wait for them: {name: tensor}
    ... the host Adam updates state in place ...
    swapper.writeback(key, state)    # submit the writes
    swapper.flush_writes()           # end of the step
"""

import os
from typing import Dict, List

import torch

from ...ops.aio import AsyncIOHandle
from .async_swapper import as_host_tensor


class OptimizerStateSwapper:

    STATE_NAMES = ("exp_avg", "exp_avg_sq")

    def __init__(self, base_dir: str, pipeline_read: bool = True, pipeline_write: bool = True,
                 aio_threads: int = 2):
        self.base_dir = os.path.join(base_dir, "optimizer_state")
        os.makedirs(self.base_dir, exist_ok=True)
        self.read_handle = AsyncIOHandle(thread_count=aio_threads)
        self.write_handle = AsyncIOHandle(thread_count=aio_threads)
        self.pipeline_read = pipeline_read
        self.pipeline_write = pipeline_write
        self._meta: Dict[str, tuple] = {}  # key -> (shape, dtype)
        self._read_bufs: Dict[str, Dict[str, torch.Tensor]] = {}
        self._write_keepalive: List[torch.Tensor] = []

    def _path(self, key: str, state_name: str) -> str:
        safe = key.replace("/", "_").replace(".", "_")
        return os.path.join(self.base_dir, f"{safe}.{state_name}")

    def initialize(self, key: str, shape, dtype=torch.float32):
        """Zero moments of ``key`` on the disk."""
        self._meta[key] = (tuple(shape), dtype)
        zeros = torch.zeros(shape, dtype=dtype)
        for name in self.STATE_NAMES:
            self.write_handle.async_pwrite(zeros, self._path(key, name))
        self._write_keepalive.append(zeros)

    def has(self, key: str) -> bool:
        return key in self._meta

    def _submit_reads(self, key: str):
        shape, dtype = self._meta[key]
        bufs = {name: torch.empty(shape, dtype=dtype) for name in self.STATE_NAMES}
        for name, buf in bufs.items():
            self.read_handle.async_pread(buf, self._path(key, name))
        self._read_bufs[key] = bufs

    def prefetch(self, key: str):
        """Submit the reads of ``key``'s moments; with ``pipeline_read`` off
        a no-op (``fetch`` then reads them itself)."""
        if self.pipeline_read:
            self._submit_reads(key)

    def fetch(self, key: str) -> Dict[str, torch.Tensor]:
        """Wait for ``key``'s reads; {state name: tensor}."""
        if key not in self._read_bufs:
            self._submit_reads(key)
        self.read_handle.wait()
        return self._read_bufs.pop(key)

    def writeback(self, key: str, arrays: Dict[str, torch.Tensor], async_op: bool = True):
        for name in self.STATE_NAMES:
            t = as_host_tensor(arrays[name])
            self.write_handle.async_pwrite(t, self._path(key, name))
            self._write_keepalive.append(t)
        if not (async_op and self.pipeline_write):
            self.flush_writes()

    def flush_writes(self):
        if self._write_keepalive:
            self.write_handle.wait()
            self._write_keepalive.clear()

    def flush(self):
        self.flush_writes()

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every key's moments, read back from the disk."""
        self.flush_writes()
        out = {}
        for key in self._meta:
            self.prefetch(key)
            out[key] = self.fetch(key)
        return out

    def load_state_dict(self, state: Dict[str, Dict[str, torch.Tensor]]):
        for key, arrays in state.items():
            some = as_host_tensor(arrays[self.STATE_NAMES[0]])
            self._meta[key] = (tuple(some.shape), some.dtype)
            self.writeback(key, arrays, async_op=True)
        self.flush_writes()
