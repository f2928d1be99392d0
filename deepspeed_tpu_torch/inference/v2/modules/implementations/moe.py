"""MoE implementations (counterpart of
``deepspeed_tpu/inference/v2/modules/implementations/moe.py``), forward
only. Both route each token to its top-k experts by the softmax of the
top-k gate logits (renormalised over the k):

- ``top_k_gated_moe``: dense dispatch, every token through every expert as
  batched einsums, combined with the top-k weights (plain products);
- ``grouped_gemm_moe``: the expert-sorted tokens through the grouped matmul
  kernels (``ops/grouped_matmul.py``), work scaling with the T * k routed
  tokens.

No engine calls them yet: the ragged forward runs dense MLPs only, as the
TPU package's v2 flat model does.
"""

import torch
import torch.nn.functional as F

from .....moe.grouped import grouped_moe_ffn, top_k_lowest_index
from ..configs import DSMoEConfig
from ..interfaces import DSMoEBase, DSMoERegistry


def _route(x, gate_w, cfg):
    """(top-k expert ids [T, k], their weights [T, k] in the compute dtype)."""
    dt = cfg.dtype
    logits = (x.to(dt) @ gate_w.to(dt)).float()
    top_vals, top_idx = top_k_lowest_index(logits, cfg.top_k)
    return top_idx, torch.softmax(top_vals, dim=-1).to(dt)


def _act(up, gate):
    return F.silu(gate) * up if gate is not None else F.gelu(up, approximate="tanh")


@DSMoERegistry.register_module
class TopKGatedMoE(DSMoEBase):

    @staticmethod
    def name() -> str:
        return "top_k_gated_moe"

    @staticmethod
    def supports_config(config: DSMoEConfig) -> bool:
        return 1 <= config.top_k <= config.n_experts

    def __call__(self, x, gate_w, expert_up, expert_gate, expert_down):
        dt = self.config.dtype
        x = x.to(dt)
        top_idx, weights = _route(x, gate_w, self.config)
        combine = torch.zeros((x.shape[0], gate_w.shape[1]), dtype=dt, device=x.device)
        combine.scatter_(1, top_idx, weights)  # [T, E]: nonzero on the top-k experts only
        up = torch.einsum("th,ehf->etf", x, expert_up.to(dt))
        gate = (torch.einsum("th,ehf->etf", x, expert_gate.to(dt))
                if expert_gate is not None else None)
        out = torch.einsum("etf,efh->eth", _act(up, gate), expert_down.to(dt))
        return torch.einsum("te,eth->th", combine, out)


@DSMoERegistry.register_module
class GroupedGemmMoE(DSMoEBase):

    @staticmethod
    def name() -> str:
        return "grouped_gemm_moe"

    @staticmethod
    def supports_config(config: DSMoEConfig) -> bool:
        return 1 <= config.top_k <= config.n_experts

    def __call__(self, x, gate_w, expert_up, expert_gate, expert_down):
        dt = self.config.dtype
        x = x.to(dt)
        top_idx, weights = _route(x, gate_w, self.config)
        # the routing goes in as (ids, weights): no dense [T, E] round trip
        return grouped_moe_ffn(x, None, expert_up, expert_down, top_k=self.config.top_k,
                               wg=expert_gate, activation=_act, top_idx=top_idx, top_w=weights)
