"""Engine construction helpers (counterpart of
``deepspeed_tpu/inference/v2/engine_factory.py``): build by model object, or
by family name and preset size. Bloom, GPT-J, GPT-NeoX and Falcon are not
in the name map, as in the reference: build them with
``build_engine(bloom(...))`` or from a checkpoint with ``build_hf_engine``."""

from typing import Optional

from ...models import gpt2, llama2, mistral, opt, phi, qwen2
from .config_v2 import RaggedInferenceEngineConfig
from .engine_v2 import InferenceEngineV2

_BUILDERS = {"llama": llama2, "llama_v2": llama2, "mistral": mistral, "gpt2": gpt2, "opt": opt,
             "qwen2": qwen2, "phi": phi}


def build_engine(model, engine_config: Optional[RaggedInferenceEngineConfig] = None, params=None,
                 device=None):
    """Build an ``InferenceEngineV2`` from a ``models.TransformerLM``."""
    return InferenceEngineV2(model, engine_config, params=params, device=device)


def build_model_engine(model_family: str, size: str = "tiny", engine_config=None, params=None,
                       device=None, seed: int = 0, **cfg_over):
    """Build by family name (the map above). Without ``params`` the weights
    are drawn on ``device`` (default CUDA) from
    ``torch.Generator(device).manual_seed(seed)``."""
    family = model_family.lower().replace("-", "_")
    if family not in _BUILDERS:
        raise ValueError(f"unknown model family {model_family!r}; have {sorted(_BUILDERS)} (bloom, "
                         f"gptj, gpt_neox and falcon: build_engine(model) or build_hf_engine)")
    model = _BUILDERS[family](size, device=device, seed=seed, params=params, **cfg_over)
    return InferenceEngineV2(model, engine_config, device=device)
