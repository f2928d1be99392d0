"""Injection policies (reference ``deepspeed/module_inject/containers/``:
per-model policy classes telling the injector which weights are attention
qkv/output and MLP in/out, so that they can be split over the model group).

Counterpart of ``deepspeed_tpu/module_inject/policies.py``: a policy is a
table of (parameter-path regex -> tensor-parallel spec over the ``model``
axis), the spec a tuple of axis names (``PartitionRules``' form, not a
``jax`` ``PartitionSpec``). Column-parallel (output dim split) for QKV and
the MLP's input, row-parallel (input dim split) for the attention output
and the MLP's output: the Megatron split the reference encodes per
container.
"""

import re
from typing import Dict, List, Tuple

from ..parallel.mesh import MODEL_AXIS
from ..runtime.zero.partition import PartitionRules

COL = (None, MODEL_AXIS)  # split the output features
ROW = (MODEL_AXIS, None)  # split the input features
COL3 = (None, None, MODEL_AXIS)  # stacked-layer [L, in, out]
ROW3 = (None, MODEL_AXIS, None)


class TransformerPolicy:
    """Base policy (reference ``DSPolicy`` / ``TransformerPolicy``)."""

    #: patterns matched against 'a/b/c' parameter paths
    column_patterns: List[str] = [
        r"(^|/)(wq|wk|wv|q_proj|k_proj|v_proj|query|key|value|w_gate|w_up|gate_proj|up_proj"
        r"|fc1|wi|moe_wi|moe_wg)(/|$)",
    ]
    row_patterns: List[str] = [
        r"(^|/)(wo|o_proj|dense|out_proj|w_down|down_proj|fc2|moe_wo)(/|$)",
    ]

    # parameters whose FIRST dim is the stacked layer dim (the serving layout)
    stacked_layer_prefixes: List[str] = [r"^blocks/"]

    @classmethod
    def _is_stacked(cls, path: str) -> bool:
        return any(re.search(p, path) for p in cls.stacked_layer_prefixes)

    @classmethod
    def spec_for(cls, path: str, ndim: int):
        stacked = cls._is_stacked(path)
        for pat in cls.column_patterns:
            if re.search(pat, path):
                return (COL3 if stacked and ndim == 3 else COL) if ndim >= 2 else None
        for pat in cls.row_patterns:
            if re.search(pat, path):
                return (ROW3 if stacked and ndim == 3 else ROW) if ndim >= 2 else None
        return None

    @classmethod
    def partition_rules(cls) -> PartitionRules:
        rules: List[Tuple[str, tuple]] = []
        for pat in cls.column_patterns:
            rules.append((pat, COL3))
        for pat in cls.row_patterns:
            rules.append((pat, ROW3))
        return PartitionRules(rules)


class LlamaPolicy(TransformerPolicy):
    """llama/llama2 (reference containers/llama.py, llama2.py)."""


class MistralPolicy(LlamaPolicy):
    """mistral shares llama's layout (reference v2 mistral containers)."""


class GPTPolicy(TransformerPolicy):
    """gpt2/gpt-neo/gpt-j (reference containers/gpt2.py et al.): fused
    c_attn is column-split, c_proj row-split."""
    column_patterns = TransformerPolicy.column_patterns + [r"(^|/)c_attn(/|$)", r"(^|/)c_fc(/|$)"]
    row_patterns = TransformerPolicy.row_patterns + [r"(^|/)c_proj(/|$)"]


class OPTPolicy(TransformerPolicy):
    """opt (reference containers/opt.py)."""


class BloomPolicy(TransformerPolicy):
    """bloom (reference containers/bloom.py): fused query_key_value column,
    dense row, dense_h_to_4h column, dense_4h_to_h row."""
    column_patterns = TransformerPolicy.column_patterns + [
        r"(^|/)query_key_value(/|$)", r"(^|/)dense_h_to_4h(/|$)"
    ]
    row_patterns = TransformerPolicy.row_patterns + [r"(^|/)dense_4h_to_h(/|$)"]


class GPTNeoXPolicy(BloomPolicy):
    """gpt-neox/pythia (reference containers/gptneox.py): same fused
    query_key_value + dense_h_to_4h/4h_to_h naming as bloom."""


class GPTJPolicy(TransformerPolicy):
    """gpt-j (reference containers/gptj.py): separate q/k/v (no bias),
    fc_in column, fc_out row."""
    column_patterns = TransformerPolicy.column_patterns + [r"(^|/)fc_in(/|$)"]
    row_patterns = TransformerPolicy.row_patterns + [r"(^|/)fc_out(/|$)"]


class FalconPolicy(BloomPolicy):
    """falcon (parallel-attention container): fused query_key_value with
    MQA/GQA kv heads; the kv slice stays replicated when n_kv < tp degree
    (``sanitize_spec``'s divisibility check)."""


class Qwen2Policy(LlamaPolicy):
    """qwen2: llama layout with biased qkv; the bias vectors follow their
    projection's column split through the shared q/k/v_proj patterns."""


class PhiPolicy(TransformerPolicy):
    """phi-1.5/phi-2 (parallel-residual container): separate q/k/v with
    ``dense`` attention output and fc1/fc2 MLP, covered by the base
    patterns; listed for registry completeness."""


class BertPolicy(TransformerPolicy):
    """bert/roberta (reference containers/bert.py): self-attention q/k/v
    column, attention output + ffn output row."""
    column_patterns = TransformerPolicy.column_patterns + [r"intermediate/kernel"]
    row_patterns = TransformerPolicy.row_patterns + [r"output/kernel"]


POLICY_REGISTRY: Dict[str, type] = {
    "llama": LlamaPolicy,
    "llama2": LlamaPolicy,
    "mistral": MistralPolicy,
    "gpt2": GPTPolicy,
    "gpt": GPTPolicy,
    "gptj": GPTJPolicy,
    "gpt_neox": GPTNeoXPolicy,
    "pythia": GPTNeoXPolicy,
    "opt": OPTPolicy,
    "bert": BertPolicy,
    "roberta": BertPolicy,
    "bloom": BloomPolicy,
    "falcon": FalconPolicy,
    "qwen2": Qwen2Policy,
    "qwen": Qwen2Policy,
    "phi": PhiPolicy,
}
