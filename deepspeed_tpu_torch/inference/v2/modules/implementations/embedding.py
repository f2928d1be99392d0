"""Embedding implementation: token gather + optional learned-position add +
optional embed layernorm over the flat ragged batch."""

from typing import Optional

from .....models.transformer import _norm
from ..configs import DSEmbeddingsConfig
from ..interfaces import DSEmbeddingBase, DSEmbeddingRegistry


@DSEmbeddingRegistry.register_module
class RaggedEmbedding(DSEmbeddingBase):

    @staticmethod
    def name() -> str:
        return "ragged_embedding"

    @staticmethod
    def refusal(config: DSEmbeddingsConfig) -> Optional[str]:
        return None

    def __call__(self, params, token_ids, pos):
        cfg = self.config
        x = params["embed"]["embedding"][token_ids.long()].to(cfg.dtype)
        if cfg.positions == "learned":
            x = x + params["pos_embed"]["embedding"][pos.long()].to(cfg.dtype)
        if cfg.embed_layernorm:
            en = params["embed_norm"]
            x = _norm(x, en["scale"], en.get("bias"), cfg.norm, cfg.norm_eps)
        return x
