"""BF16 optimizer: bf16 compute tensors, fp32 masters inside.

Counterpart of ``deepspeed_tpu/runtime/bf16_optimizer.py:20-69`` (the
reference's ``BF16_Optimizer``). The engine gets these numerics without it
(its parameters are fp32 masters, cast to the compute dtype where they are
used); this class serves code written against the object API: it owns fp32
copies of the parameters (never aliases of the caller's tensors), steps
them in fp32 with one of the port's optimizers, and hands back fresh bf16
tensors each step. Tensors are lists in the order given, each on its own
device; a non-floating tensor passes through unchanged.
"""

from typing import Callable, List, Optional, Sequence

import torch

from .utils import clip_by_global_norm_


class BF16_Optimizer:
    """``init(params)`` -> bf16 compute tensors; ``step(grads)`` -> the
    updated bf16 tensors. ``init_optimizer``: a callable that builds a
    port optimizer (``runtime/optimizers.py``) over a list of fp32
    tensors, e.g. ``lambda ps: Adam(ps, 1e-3, weight_decay=0.1)``;
    ``clip_grad > 0`` clips the fp32 gradients by their global norm first
    (optax's ``clip_by_global_norm`` in front of the chain)."""

    def __init__(self, init_optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                 compute_dtype=torch.bfloat16, clip_grad: float = 0.0):
        self._build = init_optimizer
        self.compute_dtype = compute_dtype
        self.clip_grad = float(clip_grad or 0.0)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self._masters: Optional[List[torch.Tensor]] = None
        self._params: Optional[List[torch.Tensor]] = None

    def _cast_down(self) -> List[torch.Tensor]:
        return [m.detach().to(self.compute_dtype) if m.is_floating_point() else m
                for m in self._masters]

    def _floats(self):
        return [m for m in self._masters if m.is_floating_point()]

    def init(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        self._masters = [p.detach().to(torch.float32, copy=True) if p.is_floating_point()
                         else p.detach().clone() for p in params]
        self.optimizer = self._build(self._floats())
        self._params = self._cast_down()
        return self._params

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        g32 = [g.to(torch.float32) for g, m in zip(grads, self._masters) if m.is_floating_point()]
        if self.clip_grad > 0:
            clip_by_global_norm_(g32, self.clip_grad)
        for m, g in zip(self._floats(), g32):
            m.grad = g
        self.optimizer.step()
        for m in self._floats():
            m.grad = None
        self._params = self._cast_down()
        return self._params

    @property
    def param_groups(self):
        """The reference's surface: one flat group of the compute tensors."""
        return [{"params": self._params}]

    def fp32_params(self) -> List[torch.Tensor]:
        """The fp32 masters (the reference's ``fp32_groups_flat``)."""
        return self._masters

    def state_dict(self):
        """Copies (the optimizer updates its state in place)."""
        return {"state": _cloned(self.optimizer.state_dict()),
                "count": self.optimizer.count.clone(),
                "masters": [m.clone() for m in self._masters]}

    def load_state_dict(self, sd):
        for m, saved in zip(self._masters, sd["masters"]):
            m.copy_(saved)
        # torch's load keeps a tensor of the right dtype and device as it is:
        # clone, or this optimizer would update the caller's dict in place
        self.optimizer.load_state_dict(_cloned(sd["state"]))
        self.optimizer.count.copy_(sd["count"])
        self._params = self._cast_down()


def _cloned(opt_sd):
    return dict(opt_sd, state={k: {n: v.clone() if torch.is_tensor(v) else v
                                   for n, v in st.items()}
                               for k, st in opt_sd["state"].items()})
