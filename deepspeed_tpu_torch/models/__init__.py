"""Model families of the PyTorch port."""

from .bloom import bloom, bloom_config
from .convert import params_from_jax, params_to_numpy
from .falcon import falcon, falcon_config
from .gpt import gpt2, gpt2_config
from .gpt_neox import gpt_neox, gpt_neox_config
from .gptj import gptj, gptj_config
from .llama import llama2, llama2_config
from .mistral import mistral, mistral_config
from .opt import opt, opt_config
from .phi import phi, phi_config
from .qwen import qwen2, qwen2_config
from .transformer import TransformerConfig, TransformerLM, init_params, reference_attention

__all__ = ["TransformerConfig", "TransformerLM", "init_params", "reference_attention", "llama2",
           "llama2_config", "mistral", "mistral_config", "gpt2", "gpt2_config", "phi",
           "phi_config", "qwen2", "qwen2_config", "opt", "opt_config", "bloom", "bloom_config",
           "gptj", "gptj_config", "gpt_neox", "gpt_neox_config", "falcon", "falcon_config",
           "params_from_jax", "params_to_numpy"]
