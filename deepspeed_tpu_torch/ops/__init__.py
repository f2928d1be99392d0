"""Op registry.

Counterpart of ``deepspeed_tpu/ops/__init__.py`` (the reference's
``op_builder/all_ops.py`` registry). The port's kernels are built from
their CUDA sources at first use (``ops/_build.py``), so a "builder" here is
a lazy import handle of the module that holds an op: ``load()`` imports it,
``is_compatible()`` says whether it imports. The registry is keyed by the
reference builder class names, and holds only the ops the port has; an
unknown name resolves to None, as in the JAX package.
"""

import importlib


class OpBuilder:

    NAME = "base"

    def __init__(self, module_path, symbol=None):
        self.module_path = module_path
        self.symbol = symbol

    def is_compatible(self):
        try:
            importlib.import_module(self.module_path)
            return True
        except ImportError:
            return False

    def load(self):
        mod = importlib.import_module(self.module_path)
        return getattr(mod, self.symbol) if self.symbol else mod


def _builder(name, module_path, symbol=None):
    b = OpBuilder(module_path, symbol)
    b.NAME = name
    return b


# get_accelerator().create_op_builder("FusedAdamBuilder") resolves here.
op_registry = {
    "FusedAdamBuilder": _builder("fused_adam", "deepspeed_tpu_torch.ops.adam.fused_adam"),
    # Lamb, Lion and Adagrad are the optax-equivalent optimizers of
    # runtime/optimizers.py, as in the JAX registry
    "FusedLambBuilder": _builder("fused_lamb", "deepspeed_tpu_torch.runtime.optimizers"),
    "FusedLionBuilder": _builder("fused_lion", "deepspeed_tpu_torch.runtime.optimizers"),
    "CPULionBuilder": _builder("cpu_lion", "deepspeed_tpu_torch.runtime.optimizers"),
    "CPUAdagradBuilder": _builder("cpu_adagrad", "deepspeed_tpu_torch.runtime.optimizers"),
    # ZeRO-Offload's host ops (g++ at first use: ops/_build.py::build_host_op)
    "CPUAdamBuilder": _builder("cpu_adam", "deepspeed_tpu_torch.ops.adam.cpu_adam"),
    "AsyncIOBuilder": _builder("async_io", "deepspeed_tpu_torch.ops.aio"),
    "FlashAttnBuilder": _builder("flash_attn", "deepspeed_tpu_torch.ops.flash_attention"),
    # the training transformer kernel stack is the flash path (the
    # reference's TransformerBuilder / StochasticTransformerBuilder kernels)
    "TransformerBuilder": _builder("transformer", "deepspeed_tpu_torch.ops.flash_attention"),
    "StochasticTransformerBuilder": _builder(
        "stochastic_transformer", "deepspeed_tpu_torch.ops.flash_attention"),
    # fused inference kernels
    "InferenceBuilder": _builder("transformer_inference",
                                 "deepspeed_tpu_torch.ops.paged_attention"),
    "InferenceCutlassBuilder": _builder("inference_cutlass",
                                        "deepspeed_tpu_torch.ops.paged_attention"),
    "RaggedOpsBuilder": _builder("ragged_ops", "deepspeed_tpu_torch.ops.paged_attention"),
    "RaggedUtilsBuilder": _builder("ragged_utils", "deepspeed_tpu_torch.inference.v2.ragged"),
    "SparseAttnBuilder": _builder("sparse_attn", "deepspeed_tpu_torch.ops.sparse_attention"),
    "EvoformerAttnBuilder": _builder("evoformer_attn",
                                     "deepspeed_tpu_torch.ops.evoformer_attention"),
}
