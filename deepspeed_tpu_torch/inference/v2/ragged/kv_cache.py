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
"""

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

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    def reserve(self, n_blocks: int):
        """Allocate ``n_blocks`` at refcount 1."""
        return self._allocator.allocate(n_blocks)

    def free(self, blocks) -> None:
        self._allocator.free(blocks)

    def release(self, blocks) -> None:
        """Drop one reference per block; physical free happens at zero."""
        self._allocator.release(blocks)

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
