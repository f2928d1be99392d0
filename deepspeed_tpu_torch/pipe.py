"""Top-level pipe namespace (``deepspeed_tpu/pipe.py``, the reference's
``deepspeed/pipe/__init__.py``): the pipeline container types."""

from .runtime.pipe import LayerSpec, PipelineModule, TiedLayerSpec  # noqa: F401
