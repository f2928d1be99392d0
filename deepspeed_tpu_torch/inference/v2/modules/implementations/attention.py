"""Ragged paged-attention implementations.

- ``dense_blocked_attention``: the plain gather version
  (``ops.paged_attention.paged_attention_reference``) on any device: the
  numerics reference, and what a caller gets by asking for it explicitly.
- ``paged_cuda_attention``: the hand-written CUDA kernels through
  ``ops.paged_attention.paged_attention`` (prefill tiles, per-token decode,
  split-K decode). Takes the place of the TPU package's
  ``paged_pallas_attention``. On CUDA tensors it launches a kernel or
  raises; on CPU tensors the kernel wrappers use the plain version.
"""

from typing import Optional

import torch

from .....models.transformer import alibi_slopes
from .....ops.paged_attention import (paged_attention, paged_attention_reference,
                                      unsupported_shape)
from ..configs import DSSelfAttentionConfig
from ..interfaces import DSSelfAttentionBase, DSSelfAttentionRegistry


class _PagedAttentionBase(DSSelfAttentionBase):

    def __init__(self, config, implementation_config=None):
        super().__init__(config, implementation_config)
        self._slopes = {}  # device -> fp32 slopes tensor (alibi models only)

    @staticmethod
    def refusal(config: DSSelfAttentionConfig) -> Optional[str]:
        nq, nkv = config.num_heads, max(config.num_kv_heads, 1)
        return f"{nq} query heads over {nkv} kv heads (not a multiple)" if nq % nkv else None

    def _alibi(self, device):
        if self.config.positions != "alibi":
            return None
        if device not in self._slopes:
            self._slopes[device] = torch.as_tensor(alibi_slopes(self.config.num_heads),
                                                   dtype=torch.float32, device=device)
        return self._slopes[device]


@DSSelfAttentionRegistry.register_module
class DenseBlockedAttention(_PagedAttentionBase):

    @staticmethod
    def name() -> str:
        return "dense_blocked_attention"

    def __call__(self, q, k_flat, v_flat, tables_l, seq_idx, pos, k_scale=None, v_scale=None):
        cfg = self.config
        return paged_attention_reference(q, k_flat, v_flat, tables_l, seq_idx, pos,
                                         cfg.block_size, window=cfg.sliding_window,
                                         alibi=self._alibi(q.device), k_scale=k_scale,
                                         v_scale=v_scale)


@DSSelfAttentionRegistry.register_module
class CudaPagedAttention(_PagedAttentionBase):

    @staticmethod
    def name() -> str:
        return "paged_cuda_attention"

    @staticmethod
    def refusal(config: DSSelfAttentionConfig) -> Optional[str]:
        """The kernels' limits (``ops.paged_attention.unsupported_shape``)."""
        misses = unsupported_shape(config.num_heads, max(config.num_kv_heads, 1),
                                   config.head_dim)
        return "; ".join(misses) + " (ROADMAP A5b)" if misses else None

    def __call__(self, q, k_flat, v_flat, tables_l, seq_idx, pos, k_scale=None, v_scale=None):
        cfg = self.config
        return paged_attention(q, k_flat, v_flat, tables_l, seq_idx, pos, cfg.block_size,
                               window=cfg.sliding_window, alibi=self._alibi(q.device),
                               k_scale=k_scale, v_scale=v_scale)
