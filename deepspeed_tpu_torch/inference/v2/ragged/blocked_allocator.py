"""Free-list KV block allocator with per-block refcounts (copy of
``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py`` without the
tenant-metering hook).

Host-side bookkeeping only: the device sees just the block tables built from
it. ``allocate`` hands blocks out at refcount 1; every further holder
(another sequence sharing the block, or the prefix cache's radix tree) takes
a reference with ``incref``; ``release`` drops one and relinks the block
onto the free list at zero. A block's contents are immutable while its
refcount exceeds one: writers copy it first (``BlockedKVCache.copy_block``).
Releasing a free block or an id never allocated raises.
"""

from typing import Iterable, Union

import numpy as np


class BlockedAllocator:

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"allocator requires at least 1 block, got {num_blocks}")
        self._num_blocks = int(num_blocks)
        self._next = np.arange(1, num_blocks + 1, dtype=np.int64)  # singly-linked free list
        self._head = 0
        self._free = num_blocks
        self._refcount = np.zeros(num_blocks, dtype=np.int64)  # 0 = on the free list
        # cache telemetry (``cache_telemetry.CacheTelemetry``): None keeps
        # every lifecycle event at one attribute check
        self.telemetry = None

    @property
    def free_blocks(self) -> int:
        return self._free

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    def refcount(self, block: int) -> int:
        """Current holder count of ``block`` (0 = free)."""
        b = int(block)
        if not 0 <= b < self._num_blocks:
            raise ValueError(f"invalid block id {b}")
        return int(self._refcount[b])

    def refcount_snapshot(self) -> np.ndarray:
        """A copy of the whole refcount table."""
        return self._refcount.copy()

    def allocate(self, num_blocks: int) -> np.ndarray:
        """Pop ``num_blocks`` block ids at refcount 1; raises ValueError when
        exhausted."""
        if num_blocks < 1:
            raise ValueError(f"must allocate at least 1 block, got {num_blocks}")
        if num_blocks > self._free:
            raise ValueError(f"requested {num_blocks} blocks, only {self._free} free")
        out = np.empty(num_blocks, dtype=np.int64)
        for i in range(num_blocks):
            out[i] = self._head
            self._head = self._next[self._head]
        self._free -= num_blocks
        self._refcount[out] = 1
        if self.telemetry is not None:
            self.telemetry.on_allocate(out)
        return out

    def incref(self, blocks: Union[int, Iterable[int]]) -> None:
        """One more holder per block (sharing). Blocks must be live."""
        for b in self._as_ids(blocks):
            if self._refcount[b] == 0:
                raise ValueError(f"incref on free block {b}: only allocated blocks can be shared")
            self._refcount[b] += 1

    def release(self, blocks: Union[int, Iterable[int]]) -> None:
        """Drop one reference per block; a block returns to the free list only
        at refcount zero."""
        freed = [] if self.telemetry is not None else None
        for b in self._as_ids(blocks):
            if self._refcount[b] == 0:
                raise ValueError(f"double free of block {b}: block is already on the free list")
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                self._next[b] = self._head
                self._head = b
                self._free += 1
                if freed is not None:
                    freed.append(b)
        if freed:
            self.telemetry.on_free(freed)

    free = release

    def _as_ids(self, blocks):
        if isinstance(blocks, (int, np.integer)):
            blocks = [int(blocks)]
        out = []
        for b in blocks:
            b = int(b)
            if not 0 <= b < self._num_blocks:
                raise ValueError(f"invalid block id {b}")
            out.append(b)
        return out
