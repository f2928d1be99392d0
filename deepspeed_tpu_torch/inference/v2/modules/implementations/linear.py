"""Linear implementation: ``blas_fp_linear``, a plain ``torch.matmul`` in
the module's compute dtype (the TPU package leaves the same product to
XLA). Weights are [in, out]."""

from typing import Optional

from ..configs import DSLinearConfig
from ..interfaces import DSLinearBase, DSLinearRegistry


@DSLinearRegistry.register_module
class BlasFPLinear(DSLinearBase):

    @staticmethod
    def name() -> str:
        return "blas_fp_linear"

    @staticmethod
    def refusal(config: DSLinearConfig) -> Optional[str]:
        return None

    def __call__(self, x, w, b=None):
        dt = self.config.dtype
        out = x.to(dt) @ w.to(dt)
        if b is not None:
            out = out + b.to(dt)
        return out
