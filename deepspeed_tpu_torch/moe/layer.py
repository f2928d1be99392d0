"""The user-facing MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``):
a TopKGate and an MOELayer over the expert FFN, with the optional residual
MLP mixed in by a learned coefficient (``use_residual``).

Expert parallelism (``ep_size > 1``): the layer's ``MOELayer`` exchanges
token slots over ``groups.get_expert_parallel_group()`` (the data group),
whose size must be ``ep_size``; ``init`` then makes this rank's
``num_experts / ep_size`` experts, marked as upstream DeepSpeed marks
expert parameters (``allreduce = False``, ``group_name``), so that a ZeRO
partition keeps them out of its flat groups. The tensor-parallel token
mappings (``moe/mappings.py``) wait for the port's tensor parallelism: at
world size 1 they are the identity.
"""

import logging
import math
from typing import Callable, Optional

import torch

from ..parallel import groups
from .sharded_moe import MOELayer, TopKGate, gelu

logger = logging.getLogger("deepspeed_tpu_torch")


class MoE:

    def __init__(self,
                 hidden_size: int,
                 expert=None,
                 num_experts: int = 1,
                 ep_size: int = 1,
                 k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True,
                 use_rts: bool = True,
                 use_tutel: bool = False,
                 enable_expert_tensor_parallelism: bool = False,
                 top2_2nd_expert_sampling: bool = True,
                 ffn_dim: Optional[int] = None,
                 activation: Callable = gelu):
        if num_experts % ep_size:
            raise ValueError(f"Number of experts ({num_experts}) should be divisible by expert "
                             f"parallel size ({ep_size})")
        self.ep_size = ep_size
        self.num_experts = num_experts
        self.num_local_experts = num_experts // ep_size
        self.use_residual = use_residual
        self.hidden_size = hidden_size
        ffn_dim = ffn_dim or 4 * hidden_size
        logger.info(f"Creating MoE layer with num_experts: {num_experts} | num_local_experts: "
                    f"{self.num_local_experts} | expert_parallel_size: {ep_size}")
        gate = TopKGate(hidden_size, num_experts, k, capacity_factor, eval_capacity_factor,
                        min_capacity, noisy_gate_policy, drop_tokens, use_rts,
                        top2_2nd_expert_sampling)
        group = groups.get_expert_parallel_group() if ep_size > 1 else None
        self.deepspeed_moe = MOELayer(gate, hidden_size, ffn_dim, self.num_local_experts,
                                      ep_size=ep_size, activation=activation, group=group)

    def init(self, generator, device=None):
        params = {"moe": self.deepspeed_moe.init(generator, device)}
        for t in params["moe"]["experts"].values():
            t.allreduce = False
            t.group_name = f"ep_size_{self.ep_size}"
        if self.use_residual:
            H, Fd = self.hidden_size, self.deepspeed_moe.ffn_dim
            params["residual_mlp"] = {
                "wi": torch.randn((H, Fd), generator=generator, device=device) / math.sqrt(H),
                "wo": torch.randn((Fd, H), generator=generator, device=device) / math.sqrt(Fd),
            }
            params["coefficient"] = torch.randn((H, 2), generator=generator, device=device) * 0.02
        return params

    def __call__(self, params, hidden_states, generator=None, train=True):
        """hidden_states [S, M] -> (output, l_aux)."""
        out, l_aux = self.deepspeed_moe(params["moe"], hidden_states, generator=generator,
                                        train=train)
        if self.use_residual:
            dt = hidden_states.dtype
            mlp = gelu(hidden_states @ params["residual_mlp"]["wi"].to(dt))
            mlp = mlp @ params["residual_mlp"]["wo"].to(dt)
            coef = torch.softmax(hidden_states @ params["coefficient"].to(dt), dim=-1)
            out = out * coef[..., 0:1] + mlp * coef[..., 1:2]
        return out, l_aux
