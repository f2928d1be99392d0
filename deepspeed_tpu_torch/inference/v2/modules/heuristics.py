"""Config -> implementation selection (counterpart of
``deepspeed_tpu/inference/v2/modules/heuristics.py``).

``build_modules`` is the one place an engine decides which implementation
serves each slot. Every slot takes ``"auto"``, an implementation name, or a
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


def instantiate_attention(attention_config: DSSelfAttentionConfig, engine_config,
                          use_kernels: bool = False):
    choice = getattr(engine_config.modules, "attention", "auto")
    default = "paged_cuda_attention" if use_kernels else "dense_blocked_attention"
    return DSSelfAttentionRegistry.instantiate_config(_bundle(choice, default, attention_config))


def instantiate_linear(linear_config: DSLinearConfig, engine_config):
    if getattr(engine_config, "quantize_weights", False):
        raise NotImplementedError("weight-quantized linears are not ported to the PyTorch "
                                  "package yet; set quantize_weights=False")
    choice = getattr(engine_config.modules, "linear", "auto")
    return DSLinearRegistry.instantiate_config(_bundle(choice, "blas_fp_linear", linear_config))


def instantiate_embed(embed_config: DSEmbeddingsConfig, engine_config):
    choice = getattr(engine_config.modules, "embedding", "auto")
    return DSEmbeddingRegistry.instantiate_config(_bundle(choice, "ragged_embedding", embed_config))


def instantiate_unembed(unembed_config: DSUnembedConfig, engine_config):
    choice = getattr(engine_config.modules, "unembed", "auto")
    return DSUnembedRegistry.instantiate_config(_bundle(choice, "last_token_unembed",
                                                        unembed_config))


def instantiate_pre_norm(norm_config: DSNormConfig, engine_config):
    choice = getattr(engine_config.modules, "norm", "auto")
    return DSPreNormRegistry.instantiate_config(_bundle(choice, "fused_pre_norm", norm_config))


def build_modules(model_config, engine_config, use_kernels: bool = False) -> dict:
    """Derive every slot's config from the model config and instantiate the
    module set the ragged forward consumes."""
    mc = model_config
    dt = mc.dtype
    attn = DSSelfAttentionConfig(
        num_heads=mc.num_heads, num_kv_heads=mc.num_kv_heads, head_dim=mc.head_dim,
        block_size=engine_config.kv_block_size, sliding_window=mc.sliding_window,
        positions=mc.positions, dtype=dt)
    return {
        "attention": instantiate_attention(attn, engine_config, use_kernels=use_kernels),
        "linear": instantiate_linear(DSLinearConfig(dtype=dt), engine_config),
        "embedding": instantiate_embed(DSEmbeddingsConfig(
            positions=mc.positions, embed_layernorm=mc.embed_layernorm, norm=mc.norm,
            norm_eps=mc.norm_eps, dtype=dt), engine_config),
        "unembed": instantiate_unembed(DSUnembedConfig(
            tie_embeddings=mc.tie_embeddings, norm=mc.norm, norm_eps=mc.norm_eps,
            dtype=dt), engine_config),
        "norm": instantiate_pre_norm(DSNormConfig(norm=mc.norm, norm_eps=mc.norm_eps,
                                                  dtype=dt), engine_config),
    }
