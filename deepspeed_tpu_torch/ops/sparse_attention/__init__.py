"""Sparse attention (reference ``deepspeed/ops/sparse_attention/``) —
blocked sparsity layouts and the block-sparse CUDA kernel, with the JAX
package's exports."""

from .sparsity_config import (SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
                              VariableSparsityConfig, BigBirdSparsityConfig,
                              BSLongformerSparsityConfig, LocalSlidingWindowSparsityConfig,
                              build_sparsity_config)
from .attention import SparseSelfAttention, BertSparseSelfAttention, SparseAttentionUtils
from ..block_sparse_attention import (block_sparse_attention, block_sparse_attention_gathered,
                                      make_layout_lut)
