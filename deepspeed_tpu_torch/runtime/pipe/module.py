"""PipelineModule: a layer-list pipeline container.

Counterpart of ``deepspeed_tpu/runtime/pipe/module.py`` (the reference's
``runtime/pipe/module.py``: ``LayerSpec:30``, ``TiedLayerSpec:77``,
``PipelineModule:86``, ``_partition_layers:370`` with the uniform,
parameters and type-regex methods). ``LayerSpec.build`` makes the layer (an
``nn.Module`` for a torch layer class); the partition math (balancing layer
counts or parameter counts over the stages) is the JAX package's, and a
built layer's parameter count is its ``nn.Module`` parameters'. The
training engine pipelines a ``TransformerLM`` (``pipeline_stage``), whose
stages are contiguous layer slices of :func:`partition_uniform`.
"""

import logging
import re
from typing import Callable, List, Optional

import numpy as np
from torch import nn

logger = logging.getLogger("deepspeed_tpu_torch")


class LayerSpec:
    """Reference ``LayerSpec:30`` — lazy layer constructor."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self, log=False):
        if log:
            logger.info(f"building {repr(self)}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        return f"LayerSpec({getattr(self.typename, '__name__', self.typename)})"


class TiedLayerSpec(LayerSpec):
    """Reference ``TiedLayerSpec:77``: layers sharing parameters across
    stages (e.g. tied embeddings), whose gradients the owning stages sum
    (the executor's ``ReduceTiedGrads``)."""

    def __init__(self, key, typename, *module_args, forward_fn=None, tied_weight_attr="weight",
                 **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def partition_balanced(weights: List[float], num_parts: int) -> List[int]:
    """Reference ``ds_utils.partition_balanced`` — split weights into
    num_parts contiguous groups minimizing the max group weight (binary
    search over capacity)."""
    weights = [float(w) for w in weights]
    n = len(weights)
    if num_parts >= n:
        return list(range(n + 1)) + [n] * (num_parts - n)

    def parts_needed(cap):
        parts, cur = 1, 0.0
        for w in weights:
            if w > cap:
                return num_parts + 1
            if cur + w > cap:
                parts += 1
                cur = w
            else:
                cur += w
        return parts

    lo, hi = max(weights), sum(weights)
    for _ in range(100):
        mid = (lo + hi) / 2
        if parts_needed(mid) <= num_parts:
            hi = mid
        else:
            lo = mid
    # build boundaries with capacity hi
    bounds = [0]
    cur = 0.0
    for i, w in enumerate(weights):
        if cur + w > hi + 1e-9:
            bounds.append(i)
            cur = w
        else:
            cur += w
    while len(bounds) < num_parts:
        bounds.append(n)
    bounds.append(n)
    return bounds[:num_parts + 1]


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Uniform contiguous split boundaries (reference ``partition_uniform``)."""
    parts = [0] * (num_parts + 1)
    chunk = num_items // num_parts
    rem = num_items % num_parts
    for p in range(1, num_parts + 1):
        parts[p] = parts[p - 1] + chunk + (1 if p <= rem else 0)
    return parts


class PipelineModule:
    """Reference ``PipelineModule:86``.

    Accepts a list of layer callables / LayerSpecs, partitions them into
    ``num_stages`` contiguous slices. ``stage_layers(stage_id)`` returns the
    built layers of a stage; ``parts`` holds the slice boundaries.
    """

    def __init__(self, layers, num_stages: Optional[int] = None, topology=None,
                 loss_fn: Optional[Callable] = None,
                 seed_layers: bool = False, partition_method: str = "parameters",
                 activation_checkpoint_interval: int = 0):
        self._layer_specs = list(layers)
        self.loss_fn = loss_fn
        self.partition_method = partition_method
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        assert num_stages and num_stages > 0, "num_stages or topology required"
        self.num_stages = num_stages
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.parts = self._partition_layers()

    def _estimate_weights(self):
        method = self.partition_method.lower()
        n = len(self._layer_specs)
        if method == "uniform":
            return [1.0] * n
        if method == "parameters":
            weights = [self._spec_param_count(spec) for spec in self._layer_specs]
            if all(w is None for w in weights):
                logger.warning(
                    "partition_method='parameters' but no layer exposes a parameter count "
                    "(param_count / num_params / params attrs); falling back to uniform "
                    "partitioning")
                return [1.0] * n
            return [max(w, 1) if w is not None else 1 for w in weights]
        if method.startswith("type:"):
            pat = re.compile(method[5:], re.IGNORECASE)
            return [1.0 if pat.search(getattr(getattr(s, "typename", s), "__name__", str(s)))
                    else 0.0
                    for s in self._layer_specs]
        raise NotImplementedError(f"Partitioning method {self.partition_method} not implemented")

    @staticmethod
    def _probe_param_count(t):
        pc = getattr(t, "param_count", None)
        if pc is not None:
            try:
                v = pc() if callable(pc) else pc
                return int(np.sum(list(v))) if np.iterable(v) else int(v)
            except Exception:  # e.g. unbound instance method probed on the class
                pass
        np_fn = getattr(t, "num_params", None)
        if callable(np_fn):
            try:
                return int(np_fn())
            except Exception:
                pass
        if isinstance(t, nn.Module):
            return int(sum(p.numel() for p in t.parameters()))
        p = getattr(t, "params", None)
        if p is not None:
            try:
                leaves = p.values() if isinstance(p, dict) else (p if np.iterable(p) else [p])
                return int(sum(np.prod(np.shape(x)) for x in leaves))
            except Exception:
                pass
        return None

    @classmethod
    def _spec_param_count(cls, spec):
        """Parameter count of one layer spec, or None if undiscoverable.
        Probes ``param_count`` (int or callable), ``num_params()``, and a
        ``params`` array pytree — on the spec and its class first, and only
        builds the layer (lazily, once) if the cheap probes miss."""
        n = cls._probe_param_count(spec)
        if n is None and isinstance(spec, LayerSpec):
            n = cls._probe_param_count(spec.typename)
            if n is None:
                try:
                    n = cls._probe_param_count(spec.build())
                except Exception:
                    pass
        return n

    def _partition_layers(self):
        method = self.partition_method.lower()
        n = len(self._layer_specs)
        if method == "uniform":
            parts = partition_uniform(n, self.num_stages)
        else:
            parts = partition_balanced(self._estimate_weights(), self.num_stages)
        logger.info("pipeline stage partitions: " + str(
            [f"stage{i}: layers [{parts[i]}, {parts[i+1]})" for i in range(self.num_stages)]))
        return parts

    def stage_layers(self, stage_id: int):
        lo, hi = self.parts[stage_id], self.parts[stage_id + 1]
        out = []
        for spec in self._layer_specs[lo:hi]:
            out.append(spec.build() if isinstance(spec, LayerSpec) else spec)
        return out

    def num_layers_per_stage(self):
        return [self.parts[i + 1] - self.parts[i] for i in range(self.num_stages)]

    def __len__(self):
        return len(self._layer_specs)
