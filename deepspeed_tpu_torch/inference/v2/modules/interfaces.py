"""Functionality interfaces and their registries (counterpart of
``deepspeed_tpu/inference/v2/modules/interfaces.py``). Each interface fixes the call signature its
implementations honor, so the ragged forward swaps implementations without
re-plumbing."""

from abc import abstractmethod
from typing import Type

from .configs import (DSEmbeddingsConfig, DSLinearConfig, DSMoEConfig, DSNormConfig,
                      DSSelfAttentionConfig, DSUnembedConfig)
from .ds_module import DSModuleBase, DSModuleConfig
from .module_registry import DSModuleRegistryBase


class DSSelfAttentionBase(DSModuleBase):
    """Ragged paged attention: ``__call__(q, k_flat, v_flat, tables_l,
    seq_idx, pos, k_scale=None, v_scale=None)`` with q [T, nq, d];
    k_flat/v_flat the layer-flattened pools [(L*NB*bs + 1), nkv, d];
    tables_l [S, max_blocks] already offset to layer l; seq_idx/pos [T];
    k_scale/v_scale [nkv, L*NB*bs + 1] fp32 for int8 pools. Returns [T, nq, d]."""

    @staticmethod
    def config_class() -> Type[DSModuleConfig]:
        return DSSelfAttentionConfig

    @abstractmethod
    def __call__(self, q, k_flat, v_flat, tables_l, seq_idx, pos, k_scale=None, v_scale=None):
        ...


class DSSelfAttentionRegistry(DSModuleRegistryBase):
    registry = {}

    @staticmethod
    def associated_class():
        return DSSelfAttentionBase


class DSLinearBase(DSModuleBase):
    """One matrix product: ``__call__(x, w, b=None)`` -> ``x @ w (+ b)`` in
    the module's compute dtype; w is [in, out]."""

    @staticmethod
    def config_class() -> Type[DSModuleConfig]:
        return DSLinearConfig

    @abstractmethod
    def __call__(self, x, w, b=None):
        ...


class DSLinearRegistry(DSModuleRegistryBase):
    registry = {}

    @staticmethod
    def associated_class():
        return DSLinearBase


class DSEmbeddingBase(DSModuleBase):
    """``__call__(params, token_ids, pos)`` -> hidden [T, H]."""

    @staticmethod
    def config_class() -> Type[DSModuleConfig]:
        return DSEmbeddingsConfig

    @abstractmethod
    def __call__(self, params, token_ids, pos):
        ...


class DSEmbeddingRegistry(DSModuleRegistryBase):
    registry = {}

    @staticmethod
    def associated_class():
        return DSEmbeddingBase


class DSUnembedBase(DSModuleBase):
    """``__call__(params, hidden, last_idx)`` -> fp32 logits [S, V]: final
    norm, last-token gather, vocabulary projection."""

    @staticmethod
    def config_class() -> Type[DSModuleConfig]:
        return DSUnembedConfig

    @abstractmethod
    def __call__(self, params, hidden, last_idx):
        ...


class DSUnembedRegistry(DSModuleRegistryBase):
    registry = {}

    @staticmethod
    def associated_class():
        return DSUnembedBase


class DSPreNormBase(DSModuleBase):
    """``__call__(x, scale, bias=None)`` -> normalized x."""

    @staticmethod
    def config_class() -> Type[DSModuleConfig]:
        return DSNormConfig

    @abstractmethod
    def __call__(self, x, scale, bias=None):
        ...


class DSPreNormRegistry(DSModuleRegistryBase):
    registry = {}

    @staticmethod
    def associated_class():
        return DSPreNormBase


class DSMoEBase(DSModuleBase):
    """``__call__(x, gate_w, expert_up, expert_gate, expert_down)`` -> [T, H]:
    a token-level top-k routed expert MLP (x [T, H], gate_w [H, E],
    expert_up/expert_gate [E, H, F] with expert_gate None for a non-GLU
    MLP, expert_down [E, F, H]). No engine calls it yet: the ragged forward
    runs dense MLPs, as the TPU package's does."""

    @staticmethod
    def config_class() -> Type[DSModuleConfig]:
        return DSMoEConfig

    @abstractmethod
    def __call__(self, x, gate_w, expert_up, expert_gate, expert_down):
        ...


class DSMoERegistry(DSModuleRegistryBase):
    registry = {}

    @staticmethod
    def associated_class():
        return DSMoEBase
