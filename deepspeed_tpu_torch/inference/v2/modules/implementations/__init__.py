"""Concrete module implementations; importing this package registers each
with its interface's registry."""

from .attention import CudaPagedAttention, DenseBlockedAttention
from .embedding import RaggedEmbedding
from .linear import BlasFPLinear
from .moe import GroupedGemmMoE, TopKGatedMoE
from .norm import FusedPreNorm
from .unembed import LastTokenUnembed
