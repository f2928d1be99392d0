"""Blocked (paged) KV cache on the device.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py:25-216``:
one pool per K and V,

    k_pool / v_pool : [num_layers, num_blocks * block_size, num_kv_heads, head_dim]

so a token's slot is ``block_id * block_size + offset`` and layer ``l``'s
slots start at ``l * num_blocks * block_size`` in the layer-flattened view
the forward addresses. The storage carries ONE extra trailing slot past the
last layer: tokens that must not be written (batch padding) are appended
there, so the append is a plain ``index_copy_`` with no host sync and no
out-of-bounds index, and no block table ever references the slot.

``dtype=torch.int8`` (or ``"int8"``) selects the quantized cache: values
int8 with one fp32 absmax/127 scale per (token, kv head) in ``k_scale`` /
``v_scale`` of shape [nkv, L * NB * bs] (plus the scratch column in the
storage). The forward updates the pools in place.

Block-level moves for the prefix cache and its host tier:
``copy_block`` (copy-on-write), ``read_block`` (a host snapshot for
demotion) and ``write_block`` (promotion). They address a block's slots in
every layer, and its scale slots through a ``[nkv, L, NB * bs]`` view that
shares the scale pools' storage (never a reshape that could copy).
"""

from typing import NamedTuple, Optional

import torch

from ....models.transformer import resolve_device
from .blocked_allocator import BlockedAllocator


def _resolve_kv_dtype(dtype):
    if dtype in ("int8", torch.int8):
        return torch.int8
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if dtype in ("float32", torch.float32):
        return torch.float32
    raise ValueError(f"unsupported KV dtype {dtype!r}: bfloat16, int8 or float32")


class BlockSnapshot(NamedTuple):
    """One block's KV copied to host memory: k / v ``[L, bs, nkv, d]``,
    k_scale / v_scale ``[nkv, L, bs]`` fp32 (None unquantized). On a card
    the copies are queued on the current stream into pinned memory and
    ``event`` completes when they have landed; on the CPU they are done and
    ``event`` is None."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    event: Optional[object]

    def wait(self):
        """Block until the copies have landed; returns the four tensors. A
        thread other than the one that queued the copies may call it."""
        if self.event is not None:
            self.event.synchronize()
        return self.k, self.v, self.k_scale, self.v_scale


class BlockedKVCache:

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int, num_blocks: int,
                 block_size: int = 64, dtype=torch.bfloat16, device=None):
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = _resolve_kv_dtype(dtype)
        self.quantized = self.dtype == torch.int8
        self.device = resolve_device(device)
        self._allocator = BlockedAllocator(num_blocks)
        self.pool_len = self.num_blocks * self.block_size
        flat = num_layers * self.pool_len
        shape = (flat + 1, num_kv_heads, head_dim)
        self.k_flat = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_flat = torch.zeros(shape, dtype=self.dtype, device=self.device)
        view = (num_layers, self.pool_len, num_kv_heads, head_dim)
        self.k_pool = self.k_flat[:flat].view(view)
        self.v_pool = self.v_flat[:flat].view(view)
        self.k_scale_flat = self.v_scale_flat = self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale_flat = torch.zeros((num_kv_heads, flat + 1), dtype=torch.float32,
                                            device=self.device)
            self.v_scale_flat = torch.zeros_like(self.k_scale_flat)
            self.k_scale = self.k_scale_flat[:, :flat]
            self.v_scale = self.v_scale_flat[:, :flat]
            # the layer-strided view of the scales (same storage): a block's
            # scale slots are [:, :, b * bs:(b + 1) * bs]
            span = self.pool_len
            self._scale_l = (self.k_scale.view(num_kv_heads, num_layers, span),
                             self.v_scale.view(num_kv_heads, num_layers, span))

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    @property
    def total_blocks(self) -> int:
        return self._allocator.total_blocks

    def reserve(self, n_blocks: int):
        """Allocate ``n_blocks`` at refcount 1."""
        return self._allocator.allocate(n_blocks)

    def free(self, blocks) -> None:
        self._allocator.free(blocks)

    # -- refcount-aware sharing (prefix cache) -------------------------------
    def incref(self, blocks) -> None:
        """One more holder per block: its contents stay immutable until the
        count drops back to one."""
        self._allocator.incref(blocks)

    def release(self, blocks) -> None:
        """Drop one reference per block; physical free happens at zero."""
        self._allocator.release(blocks)

    def refcount(self, block) -> int:
        return self._allocator.refcount(block)

    def refcount_snapshot(self):
        return self._allocator.refcount_snapshot()

    def set_telemetry(self, telemetry) -> None:
        """Arm (or with None, disarm) the allocator's lifecycle hooks."""
        self._allocator.telemetry = telemetry

    def _span(self, block: int) -> slice:
        s = int(block) * self.block_size
        return slice(s, s + self.block_size)

    def copy_block(self, src: int, dst: int) -> None:
        """Device-side copy of one block's slots ``src`` -> ``dst`` in every
        layer (the copy-on-write primitive), scales included."""
        s, d = self._span(src), self._span(dst)
        self.k_pool[:, d].copy_(self.k_pool[:, s])
        self.v_pool[:, d].copy_(self.v_pool[:, s])
        if self.quantized:
            for sc in self._scale_l:
                sc[:, :, d].copy_(sc[:, :, s])

    def read_block(self, block: int) -> BlockSnapshot:
        """Host snapshot of one block's KV for demotion. The copies are
        queued on the current stream before anything that may later reuse
        the block, so a forward that writes into it after its release cannot
        reach the snapshot."""
        s = self._span(block)
        pin = self.device.type == "cuda"

        def snap(src):
            out = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
            out.copy_(src, non_blocking=pin)
            return out

        k, v = snap(self.k_pool[:, s]), snap(self.v_pool[:, s])
        ks = vs = None
        if self.quantized:
            ks, vs = (snap(sc[:, :, s]) for sc in self._scale_l)
        event = None
        if pin:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return BlockSnapshot(k, v, ks, vs, event)

    def write_block(self, block: int, k, v, k_scale=None, v_scale=None) -> None:
        """Promotion: install host KV (the shapes of :meth:`read_block`) into
        one block's slots. The copies have landed when it returns, so the
        host slot they came from may be reused at once. Runs between
        forwards, on the thread that drives them."""
        d = self._span(block)
        self.k_pool[:, d].copy_(torch.as_tensor(k))
        self.v_pool[:, d].copy_(torch.as_tensor(v))
        if self.quantized and k_scale is not None:
            for sc, blk in zip(self._scale_l, (k_scale, v_scale)):
                sc[:, :, d].copy_(torch.as_tensor(blk))

    def pools(self):
        """The tensors the forward reads and updates in place: (k, v) flat
        pools with the scratch slot, plus (k_scale, v_scale) when quantized."""
        if self.quantized:
            return (self.k_flat, self.v_flat, self.k_scale_flat, self.v_scale_flat)
        return (self.k_flat, self.v_flat)

    def update(self, *pools) -> None:
        """No-op kept for the TPU package's call surface: the forward
        updates the pools in place."""

    def memory_bytes(self) -> int:
        n = 2 * self.k_flat.numel() * self.k_flat.element_size()
        if self.quantized:
            n += 2 * self.k_scale_flat.numel() * 4
        return n

    def block_bytes(self) -> int:
        """Device bytes of one block across all layers (K + V, scales
        included on the int8 layout): the unit of ``cow_bytes``."""
        slots = self.num_layers * self.block_size * self.num_kv_heads
        n = 2 * slots * self.head_dim * self.k_flat.element_size()
        if self.quantized:
            n += 2 * slots * 4
        return n
