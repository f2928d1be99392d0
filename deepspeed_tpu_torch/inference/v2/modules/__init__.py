"""Pluggable inference module layer: the config -> implementation selection
point where an attention / linear / embedding / unembed / norm / MoE
implementation is swapped per op without touching the engine."""

from .configs import (DSEmbeddingsConfig, DSLinearConfig, DSMoEConfig, DSNormConfig,
                      DSSelfAttentionConfig, DSUnembedConfig)
from .ds_module import DSModuleBase, DSModuleConfig
from .heuristics import (build_modules, check_modules, instantiate_attention, instantiate_embed,
                         instantiate_linear, instantiate_pre_norm, instantiate_unembed)
from .interfaces import (DSEmbeddingBase, DSEmbeddingRegistry, DSLinearBase, DSLinearRegistry,
                         DSMoEBase, DSMoERegistry, DSPreNormBase, DSPreNormRegistry,
                         DSSelfAttentionBase, DSSelfAttentionRegistry, DSUnembedBase,
                         DSUnembedRegistry)
from .module_registry import ConfigBundle, DSModuleRegistryBase
