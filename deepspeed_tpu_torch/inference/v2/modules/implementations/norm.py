"""Pre-norm implementation: RMSNorm / LayerNorm in fp32 (``_norm``)."""

from .....models.transformer import _norm
from ..configs import DSNormConfig
from ..interfaces import DSPreNormBase, DSPreNormRegistry


@DSPreNormRegistry.register_module
class FusedPreNorm(DSPreNormBase):

    @staticmethod
    def name() -> str:
        return "fused_pre_norm"

    @staticmethod
    def supports_config(config: DSNormConfig) -> bool:
        return config.norm in ("rmsnorm", "layernorm")

    def __call__(self, x, scale, bias=None):
        return _norm(x, scale, bias, self.config.norm, self.config.norm_eps)
