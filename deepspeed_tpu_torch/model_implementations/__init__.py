"""The model namespace under the reference package's name
(``deepspeed/model_implementations``), as ``deepspeed_tpu.model_implementations``
has it: a re-export of :mod:`deepspeed_tpu_torch.models`."""

from ..models import *  # noqa: F401,F403
from ..models.transformer import TransformerConfig, TransformerLM  # noqa: F401
