"""Per-interface module configs (counterpart of
``deepspeed_tpu/inference/v2/modules/configs.py``, torch dtypes): derived
from the model config at engine build; implementations never reach back
into the model config."""

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .ds_module import DSModuleConfig


@dataclass
class DSSelfAttentionConfig(DSModuleConfig):
    """Paged ragged attention over the flat KV pool."""
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    block_size: int = 64
    sliding_window: Optional[int] = None
    positions: str = "rotary"  # 'alibi' adds slope-biased scores
    dtype: Any = torch.bfloat16


@dataclass
class DSLinearConfig(DSModuleConfig):
    """A single matrix product of the layer stack."""
    dtype: Any = torch.bfloat16


@dataclass
class DSEmbeddingsConfig(DSModuleConfig):
    """Token (+ learned position) embedding with optional embed layernorm."""
    positions: str = "rotary"
    embed_layernorm: bool = False
    norm: str = "layernorm"
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16


@dataclass
class DSUnembedConfig(DSModuleConfig):
    """Final norm + last-token gather + vocabulary projection."""
    tie_embeddings: bool = False
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16


@dataclass
class DSNormConfig(DSModuleConfig):
    """Pre-attention / pre-MLP normalization."""
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16


@dataclass
class DSMoEConfig(DSModuleConfig):
    """Token-level top-k routed expert MLP."""
    n_experts: int = 1
    top_k: int = 1
    activation: str = "swiglu"
    dtype: Any = torch.bfloat16
