"""Model families of the PyTorch port."""

from .convert import params_from_jax, params_to_numpy
from .llama import llama2, llama2_config
from .mistral import mistral, mistral_config
from .transformer import TransformerConfig, TransformerLM, init_params

__all__ = ["TransformerConfig", "TransformerLM", "init_params", "llama2", "llama2_config",
           "mistral", "mistral_config", "params_from_jax", "params_to_numpy"]
