"""Transformer-layer replacement (reference
``deepspeed/module_inject/replace_module.py:182`` ``replace_transformer_layer``:
fused inference modules in place of a model's blocks, or AutoTP's slicing of
its linears).

Counterpart of ``deepspeed_tpu/module_inject/replace_module.py``. As there,
"kernel injection" is two moves that leave the model's modules alone:

1. the compute path: the model config's ``attention_impl`` flips from the
   plain einsum to ``"auto"`` (the flash and paged kernels on the card);
2. the layout: at a model size above 1, this rank's slices. A model that
   splits itself (``TransformerLM.shard_tensor_parallel``) takes its own
   plan; a parameter tree given as ``params`` is cut by AutoTP's policy.

``revert_transformer_layer`` restores the plain attention.
"""

import logging
from typing import Optional

from .auto_tp import AutoTP

logger = logging.getLogger("deepspeed_tpu_torch")


def _model_axis(mesh):
    """(size, rank, process group) of the ``model`` axis of ``mesh`` (a
    ``DeviceMesh``), or of the current mesh of ``parallel.groups``."""
    from ..parallel import groups
    from ..parallel.mesh import MODEL_AXIS

    if mesh is None:
        return (groups.get_model_parallel_world_size(), groups.get_model_parallel_rank(),
                groups.get_model_parallel_group())
    names = tuple(mesh.mesh_dim_names or ())
    if MODEL_AXIS not in names:
        return 1, 0, None
    return (mesh.size(names.index(MODEL_AXIS)), mesh.get_local_rank(MODEL_AXIS),
            mesh.get_group(MODEL_AXIS))


def replace_transformer_layer(orig_layer_impl=None,
                              model=None,
                              checkpoint_dict=None,
                              config=None,
                              model_config=None,
                              params=None,
                              mesh=None,
                              policy=None,
                              model_type: Optional[str] = None,
                              quantize: Optional[bool] = None):
    """Kernel-inject and tensor-split a model (the reference's
    ``replace_with_policy``, signature adapted). Returns (model, params):
    the model with ``attention_impl`` 'auto', and at a model size above 1
    (of ``mesh``, else the current mesh) ``params`` cut to this rank's
    slices by AutoTP, or, without ``params``, the model split into this
    rank's shards by its own ``shard_tensor_parallel``. Quantized weights
    (``quantize``, ``config.quant.enabled``) are not ported (ROADMAP A7)."""
    model = model if model is not None else orig_layer_impl
    mc = model_config or getattr(model, "config", None)
    if mc is not None and getattr(mc, "attention_impl", None) == "reference":
        mc.attention_impl = "auto"
        logger.info("kernel injection: attention_impl -> auto (flash / paged kernels on the card)")
    if quantize or (config is not None and getattr(getattr(config, "quant", None), "enabled",
                                                      False)):
        raise NotImplementedError("quantize: int8 / int4 weight-only linears are not ported to "
                                  "the PyTorch package yet (ROADMAP A7)")
    size, rank, group = _model_axis(mesh)
    if size > 1:
        if params is not None:
            auto_tp = AutoTP(policy=policy,
                             model_type=model_type or getattr(mc, "model_type", None))
            params = auto_tp.shard(params, rank, size)
        elif hasattr(model, "shard_tensor_parallel"):
            from ..models.transformer import tensor_parallel

            model.shard_tensor_parallel(tensor_parallel(mc, group))
        logger.info(f"AutoTP: this rank's slices over the model axis (rank {rank} of {size})")
    return model, params


def revert_transformer_layer(orig_layer_impl=None, model=None, config=None):
    """Reference ``revert_transformer_layer``: the injection touched no
    module, so reverting restores the plain attention."""
    model = model if model is not None else orig_layer_impl
    mc = getattr(model, "config", None)
    if mc is not None:
        mc.attention_impl = "reference"
    return model
