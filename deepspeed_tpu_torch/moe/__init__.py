from .grouped import block_align_dispatch, grouped_moe_ffn
from .layer import MoE
from .sharded_moe import MOELayer, TopKGate, top1gating, top2gating
