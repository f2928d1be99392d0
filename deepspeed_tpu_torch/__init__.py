"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

Public surface, as ``deepspeed_tpu/__init__.py:35-127``: ``initialize``
returns ``(engine, optimizer, dataloader, lr_scheduler)``, the engine a
``DeepSpeedHybridEngine`` when the config enables ``hybrid_engine``;
``init_inference`` returns the v1 ``InferenceEngine``;
``add_config_arguments`` adds the DeepSpeed CLI flags; ``init_distributed``
initialises ``torch.distributed`` (``comm``). The training "model" is an
``nn.Module`` with ``loss(batch)`` (``models.TransformerLM(...,
trainable=True)``), or a bare ``loss_fn(params, batch)`` paired with
``model_parameters``. The ragged serving engine lives in ``inference.v2``.
``checkpointing`` is activation checkpointing (``deepspeed.checkpointing``:
``checkpoint``, ``configure``, the RNG tracker). ``module_inject`` is tensor
parallelism's surface (AutoTP, the policies, the Megatron layers), with
``replace_transformer_layer`` / ``revert_transformer_layer`` at the top, as
``deepspeed_tpu/__init__.py:28,30`` exports them. ``pipe`` and
``PipelineModule`` are the pipeline containers (``deepspeed_tpu/__init__.py:
20,23``); a ``tpu.mesh`` with ``pipe`` above 1 trains a ``TransformerLM``
one rank a stage (``runtime/pipe/engine.py``).
"""

__version__ = "0.1.0"

import os

from torch import nn

from . import module_inject, pipe
from .comm import init_distributed
from .inference.config import DeepSpeedInferenceConfig
from .inference.engine import InferenceEngine
from .runtime.activation_checkpointing import checkpointing
from .runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from .runtime.engine import DeepSpeedEngine
from .module_inject import replace_transformer_layer, revert_transformer_layer
from .runtime.hybrid_engine import DeepSpeedHybridEngine
from .runtime.pipe import PipelineModule


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               config_params=None):
    """Build the training engine (``deepspeed.initialize``'s signature).

    - ``model``: an ``nn.Module`` with ``loss(batch) -> scalar`` whose
      trainable parameters are the masters; or a callable
      ``(params, batch) -> loss`` with ``model_parameters`` (a dict or list
      of tensors) as its initial parameters.
    - ``config``: a dict or the path of a DeepSpeed JSON config.
    - ``optimizer``: a ``torch.optim.Optimizer`` over the model's parameters
      (default: the config's ``optimizer`` block).
    - ``dist_init_required``: initialise ``torch.distributed`` first
      (``init_distributed``); None does so when the environment holds
      ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets them. The engine then
      trains data-parallel over every rank (one rank a card).
    """
    assert model is not None, "deepspeed_tpu_torch.initialize: model is required"
    if config is None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    assert config is not None, "DeepSpeed requires --deepspeed_config to specify configuration file"
    ds_config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    if dist_init_required or (dist_init_required is None
                              and all(v in os.environ for v in ("RANK", "WORLD_SIZE"))):
        init_distributed(dist_init_required=True)
    if not isinstance(model, nn.Module) and callable(model):
        model = _FunctionalModel(model, model_parameters)
    hybrid = ds_config.hybrid_engine_config.enabled
    engine = (DeepSpeedHybridEngine if hybrid else DeepSpeedEngine)(
        model=model, config=ds_config, optimizer=optimizer, lr_scheduler=lr_scheduler,
        training_data=training_data, collate_fn=collate_fn)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def _parameter(t):
    """A trainable parameter of ``t``, keeping upstream DeepSpeed's expert
    marks (``allreduce``, ``group_name``; ``moe.MoE.init`` sets them)."""
    p = nn.Parameter(t)
    for mark in ("allreduce", "group_name"):
        if hasattr(t, mark):
            setattr(p, mark, getattr(t, mark))
    return p


class _FunctionalModel(nn.Module):
    """Adapter: a bare ``loss_fn(params, batch)`` and its initial parameters
    (a dict or list of tensors, registered as trainable parameters) -> the
    model protocol (``loss(batch)``)."""

    def __init__(self, loss_fn, init_params):
        super().__init__()
        assert init_params is not None, "pass model_parameters with a bare loss function"
        self._loss_fn = loss_fn
        if isinstance(init_params, dict):
            self.params = nn.ParameterDict({k: _parameter(v) for k, v in init_params.items()})
        else:
            self.params = nn.ParameterList([_parameter(v) for v in init_params])

    def loss(self, batch, params=None):
        if params is None:
            params = (dict(self.params) if isinstance(self.params, nn.ParameterDict)
                      else list(self.params))
        return self._loss_fn(params, batch)

    def gathered_params(self, gather):
        """The parameters of a ZeRO-3 forward: ``gather(0)`` is the one
        group (every parameter), keyed by parameter name."""
        leaves = gather(0)
        if isinstance(self.params, nn.ParameterDict):
            return {k: leaves[f"params.{k}"] for k in self.params.keys()}
        return [leaves[f"params.{i}"] for i in range(len(self.params))]


def init_inference(model=None, config=None, *, device=None, **kwargs):
    """Build the v1 ``InferenceEngine`` around ``model`` (a
    ``models.TransformerLM``; ``deepspeed.init_inference``'s semantics,
    ``deepspeed_tpu/__init__.py:106``). ``config``: a
    ``DeepSpeedInferenceConfig`` or its JSON dict (aliases accepted), else
    the keyword arguments (``tensor_parallel={"tp_size": N}`` serves over
    N ranks of the initialised process group, each its shards). ``device``
    defaults to CUDA."""
    if config is None:
        config = kwargs
    if not isinstance(config, DeepSpeedInferenceConfig):
        config = DeepSpeedInferenceConfig.from_dict(config or {})
    return InferenceEngine(model, config, device=device)


def add_config_arguments(parser):
    """``deepspeed.add_config_arguments``: the DeepSpeed CLI flags."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code, no impact on DS itself)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated, use --deepspeed")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated, use --deepspeed_config")
    return parser


__all__ = ["DeepSpeedConfig", "DeepSpeedConfigError", "DeepSpeedEngine", "DeepSpeedHybridEngine",
           "DeepSpeedInferenceConfig", "InferenceEngine", "add_config_arguments", "checkpointing",
           "PipelineModule", "init_distributed", "init_inference", "initialize", "module_inject",
           "pipe", "replace_transformer_layer", "revert_transformer_layer"]
