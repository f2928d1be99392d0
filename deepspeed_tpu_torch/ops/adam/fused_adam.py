"""Fused Adam(W) optimizer over fp32 masters.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``: ``FusedAdamState
(step, mu, nu)`` and the optimizer object that holds it. The update runs
through :func:`deepspeed_tpu_torch.ops.fused_adam.fused_adam_apply` (the
hand-written multi-tensor kernel on CUDA, its plain version on the CPU).
The engine drives :meth:`FusedAdam.apply` with the loss un-scaling, the clip
coefficient and the overflow gate folded in; :meth:`FusedAdam.step` is the
plain ``torch.optim`` entry (ungated, unscaled ``p.grad``).
"""

from typing import List, NamedTuple

import torch

from ..fused_adam import fused_adam_apply


class FusedAdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the params' device: updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class FusedAdam(torch.optim.Optimizer):
    """AdamW (decoupled weight decay) with the fused kernel. ``lr`` is a
    float or a ``step -> lr`` schedule of torch ops, evaluated on the
    device's update counter."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adam_w_mode=True):
        if not adam_w_mode and weight_decay:
            raise NotImplementedError("FusedAdam fuses decoupled weight decay (AdamW) only; "
                                      "Adam with L2 weight decay takes the optax-equivalent "
                                      "optimizer (runtime/optimizers.py)")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        ps = self.flat_params()
        for p in ps:
            if p.dtype != torch.float32:
                raise ValueError("FusedAdam updates fp32 master parameters only")
        self.fused_state = FusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=ps[0].device),
            mu=[torch.zeros_like(p) for p in ps], nu=[torch.zeros_like(p) for p in ps])

    def flat_params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def lr_at(self, count):
        lr = self.param_groups[0]["lr"]
        return lr(count) if callable(lr) else lr

    @torch.no_grad()
    def apply(self, grads, *, lr_t, grad_scale=1.0, gate=1.0):
        """One gated update; the step counter advances only where gate > 0."""
        g = self.param_groups[0]
        st = self.fused_state
        b1, b2 = g["betas"]
        fused_adam_apply(self.flat_params(), st.mu, st.nu, grads, lr_t=lr_t, b1=b1, b2=b2,
                         eps=g["eps"], weight_decay=g["weight_decay"], step=st.step + 1,
                         grad_scale=grad_scale, gate=gate)
        ok = (gate > 0) if torch.is_tensor(gate) else torch.full((), float(gate) > 0,
                                                                  device=st.step.device)
        st.step.add_(ok.to(torch.int32))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        ps = self.flat_params()
        self.apply([p.grad for p in ps], lr_t=self.lr_at(self.fused_state.step))
        return loss
