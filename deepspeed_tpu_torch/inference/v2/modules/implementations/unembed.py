"""Unembed implementation: final norm -> last-token gather (only each
sequence's last token is projected to the vocabulary) -> tied/untied head.
Logits are computed in the model dtype, then cast to fp32."""

import torch

from .....models.transformer import _norm
from ..configs import DSUnembedConfig
from ..interfaces import DSUnembedBase, DSUnembedRegistry


@DSUnembedRegistry.register_module
class LastTokenUnembed(DSUnembedBase):

    @staticmethod
    def name() -> str:
        return "last_token_unembed"

    @staticmethod
    def supports_config(config: DSUnembedConfig) -> bool:
        return True

    def __call__(self, params, hidden, last_idx):
        cfg = self.config
        h_last = hidden[last_idx.long()]  # the norm is per row: gather first
        h = _norm(h_last, params["final_norm"]["scale"], params["final_norm"].get("bias"),
                  cfg.norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = h @ params["embed"]["embedding"].to(cfg.dtype).t()
        else:
            logits = h @ params["lm_head"]["kernel"].to(cfg.dtype)
            if "bias" in params["lm_head"]:
                logits = logits + params["lm_head"]["bias"].to(logits.dtype)
        return logits.to(torch.float32)
