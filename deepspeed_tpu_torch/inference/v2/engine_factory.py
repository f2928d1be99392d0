"""Engine construction helpers (counterpart of
``deepspeed_tpu/inference/v2/engine_factory.py``): build by model object, or
by family name and preset size."""

from typing import Optional

from ...models import llama2, mistral
from .config_v2 import RaggedInferenceEngineConfig
from .engine_v2 import InferenceEngineV2

_BUILDERS = {"llama": llama2, "llama_v2": llama2, "mistral": mistral}


def build_engine(model, engine_config: Optional[RaggedInferenceEngineConfig] = None, params=None,
                 device=None):
    """Build an ``InferenceEngineV2`` from a ``models.TransformerLM``."""
    return InferenceEngineV2(model, engine_config, params=params, device=device)


def build_model_engine(model_family: str, size: str = "tiny", engine_config=None, params=None,
                       device=None, seed: int = 0, **cfg_over):
    """Build by family name ("mistral" | "llama"). Without ``params`` the
    weights are drawn on ``device`` (default CUDA) from
    ``torch.Generator(device).manual_seed(seed)``."""
    family = model_family.lower().replace("-", "_")
    if family not in _BUILDERS:
        raise ValueError(f"unknown or unported model family {model_family!r}; the PyTorch "
                         f"package has {sorted(_BUILDERS)}")
    model = _BUILDERS[family](size, device=device, seed=seed, params=params, **cfg_over)
    return InferenceEngineV2(model, engine_config, device=device)
