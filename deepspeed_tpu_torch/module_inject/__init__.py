"""Tensor parallelism's surface (``deepspeed.module_inject``): AutoTP's specs
and slicing, the policies, ``replace_transformer_layer``, and the
tensor-parallel layers and regions the model's forward runs through."""

from . import layers, tp_shard
from .auto_tp import AutoTP, ReplaceWithTensorSlicing
from .layers import (embedding_layer, linear_allreduce, linear_layer, lm_head_linear_allreduce,
                     normalize, opt_embedding, rms_normalize)
from .policies import (POLICY_REGISTRY, BertPolicy, GPTPolicy, LlamaPolicy, MistralPolicy,
                       OPTPolicy, TransformerPolicy)
from .replace_module import replace_transformer_layer, revert_transformer_layer
from .tp_shard import get_num_kv_heads, get_shard_size, get_shard_size_list, set_num_kv_heads
