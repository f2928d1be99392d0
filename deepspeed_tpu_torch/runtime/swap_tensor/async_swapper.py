"""Asynchronous swap-out of host tensors to files.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/async_swapper.py`` (the
reference's ``AsyncTensorSwapper``): writes go out through an
:class:`~deepspeed_tpu_torch.ops.aio.AsyncIOHandle` with at most
``max_inflight`` pending, so compute overlaps them while the host memory
they hold stays bounded.
"""

import os
from collections import deque

import torch

from ...ops.aio import AsyncIOHandle


def as_host_tensor(t) -> torch.Tensor:
    """A contiguous CPU tensor of ``t`` (a tensor or numpy array), without a
    copy where it already is one."""
    t = t if torch.is_tensor(t) else torch.from_numpy(t)
    return t.detach().cpu().contiguous()


class AsyncTensorSwapper:
    """``swap_out_tensors([(tensor, path), ...])`` submits the writes and
    keeps each buffer alive until its write has completed."""

    def __init__(self, aio_handle: AsyncIOHandle = None, max_inflight: int = 8):
        self.handle = aio_handle or AsyncIOHandle()
        self._own_handle = aio_handle is None
        self.max_inflight = max_inflight
        self._inflight = deque()
        self.swap_bytes = 0

    def swap_out_tensors(self, tensor_path_pairs):
        for t, path in tensor_path_pairs:
            t = as_host_tensor(t)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if len(self._inflight) >= self.max_inflight:
                self.synchronize()
            self.handle.async_pwrite(t, path)
            self._inflight.append(t)
            self.swap_bytes += t.numel() * t.element_size()

    def synchronize(self):
        """Wait for every pending write."""
        if self._inflight:
            self.handle.wait()
            self._inflight.clear()

    def shutdown(self):
        self.synchronize()
        if self._own_handle:
            self.handle.close()
