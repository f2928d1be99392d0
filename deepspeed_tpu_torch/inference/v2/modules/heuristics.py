"""Config -> implementation selection (counterpart of
``deepspeed_tpu/inference/v2/modules/heuristics.py``).

``build_modules`` is the one place an engine decides which implementation
serves each slot (``check_modules`` asks the same implementations whether
they take the config, without building them). Every slot takes ``"auto"``, an implementation name, or a
``{"name": ..., "implementation_config": {...}}`` dict.

Auto policy:
- attention: the CUDA paged kernels (``paged_cuda_attention``) whenever the
  engine's tensors are on CUDA, else the plain gather version
  (``dense_blocked_attention``);
- linear: ``blas_fp_linear`` (``torch.matmul`` in the compute dtype); the
  quantized-weight linears are not ported in this slice;
- embedding / unembed / norm: the single implementation each.
"""

from typing import Union

from . import implementations  # noqa: F401  (populates the registries)
from .configs import (DSEmbeddingsConfig, DSLinearConfig, DSNormConfig, DSSelfAttentionConfig,
                      DSUnembedConfig)
from .interfaces import (DSEmbeddingRegistry, DSLinearRegistry, DSPreNormRegistry,
                         DSSelfAttentionRegistry, DSUnembedRegistry)
from .module_registry import ConfigBundle


def _bundle(choice: Union[str, dict], default_name: str, config) -> ConfigBundle:
    if isinstance(choice, dict):
        return ConfigBundle(name=choice.get("name", default_name), config=config,
                            implementation_config=choice.get("implementation_config", {}))
    name = default_name if choice in (None, "auto") else choice
    return ConfigBundle(name=name, config=config)


def _choice(slot: str, registry, default: str, config, engine_config):
    """(registry, bundle) of the implementation ``engine_config`` picks for
    ``slot``."""
    return registry, _bundle(getattr(engine_config.modules, slot, "auto"), default, config)


def _attention(attention_config, engine_config, use_kernels):
    default = "paged_cuda_attention" if use_kernels else "dense_blocked_attention"
    return _choice("attention", DSSelfAttentionRegistry, default, attention_config, engine_config)


def _linear(linear_config, engine_config):
    if getattr(engine_config, "quantize_weights", False):
        raise NotImplementedError("weight-quantized linears are not ported to the PyTorch "
                                  "package yet; set quantize_weights=False")
    return _choice("linear", DSLinearRegistry, "blas_fp_linear", linear_config, engine_config)


def _instantiate(choice):
    registry, bundle = choice
    return registry.instantiate_config(bundle)


def instantiate_attention(attention_config: DSSelfAttentionConfig, engine_config,
                          use_kernels: bool = False):
    return _instantiate(_attention(attention_config, engine_config, use_kernels))


def instantiate_linear(linear_config: DSLinearConfig, engine_config):
    return _instantiate(_linear(linear_config, engine_config))


def instantiate_embed(embed_config: DSEmbeddingsConfig, engine_config):
    return _instantiate(_choice("embedding", DSEmbeddingRegistry, "ragged_embedding",
                                embed_config, engine_config))


def instantiate_unembed(unembed_config: DSUnembedConfig, engine_config):
    return _instantiate(_choice("unembed", DSUnembedRegistry, "last_token_unembed",
                                unembed_config, engine_config))


def instantiate_pre_norm(norm_config: DSNormConfig, engine_config):
    return _instantiate(_choice("norm", DSPreNormRegistry, "fused_pre_norm", norm_config,
                                engine_config))


def _choices(model_config, engine_config, use_kernels: bool) -> dict:
    """slot -> (registry, bundle): every slot's config derived from the model
    config, and the implementation the engine config picks for it."""
    mc = model_config
    dt = mc.dtype
    attn = DSSelfAttentionConfig(
        num_heads=mc.num_heads, num_kv_heads=mc.num_kv_heads, head_dim=mc.head_dim,
        block_size=engine_config.kv_block_size, sliding_window=mc.sliding_window,
        positions=mc.positions, dtype=dt)
    return {
        "attention": _attention(attn, engine_config, use_kernels),
        "linear": _linear(DSLinearConfig(dtype=dt), engine_config),
        "embedding": _choice("embedding", DSEmbeddingRegistry, "ragged_embedding",
                             DSEmbeddingsConfig(positions=mc.positions,
                                                embed_layernorm=mc.embed_layernorm,
                                                norm=mc.norm, norm_eps=mc.norm_eps, dtype=dt),
                             engine_config),
        "unembed": _choice("unembed", DSUnembedRegistry, "last_token_unembed",
                           DSUnembedConfig(tie_embeddings=mc.tie_embeddings, norm=mc.norm,
                                           norm_eps=mc.norm_eps, dtype=dt), engine_config),
        "norm": _choice("norm", DSPreNormRegistry, "fused_pre_norm",
                        DSNormConfig(norm=mc.norm, norm_eps=mc.norm_eps, dtype=dt),
                        engine_config),
    }


def check_modules(model_config, engine_config, use_kernels: bool = False) -> None:
    """Raise as :func:`build_modules` would for a config some picked
    implementation refuses, naming what it misses, without building any
    module."""
    for registry, bundle in _choices(model_config, engine_config, use_kernels).values():
        registry.resolve(bundle)


def build_modules(model_config, engine_config, use_kernels: bool = False) -> dict:
    """Derive every slot's config from the model config and instantiate the
    module set the ragged forward consumes."""
    return {slot: _instantiate(c)
            for slot, c in _choices(model_config, engine_config, use_kernels).items()}
