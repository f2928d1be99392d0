"""The weights carrier between the two packages.

The TPU package's parameter tree and the port's share names and layout
(stacked ``[L, ...]`` blocks, weights ``[in, out]``), so conversion is a
name-for-name copy plus a dtype cast: matrix weights (and embeddings) take
the serving ``dtype``, norm scales and biases stay fp32. The TPU side hands
its tree over as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``.
"""

from typing import Any, Dict

import numpy as np
import torch

from .transformer import MATMUL_WEIGHTS, TransformerConfig, resolve_device

_DTYPE_KEYS = {("embed", "embedding"), ("pos_embed", "embedding"), ("lm_head", "kernel")}


def _takes_serving_dtype(group: str, name: str) -> bool:
    return (group, name) in _DTYPE_KEYS or (group == "blocks" and name in MATMUL_WEIGHTS)


def params_from_jax(np_params: Dict[str, Any], cfg: TransformerConfig, device=None,
                    dtype=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """numpy parameter tree (TPU package layout) -> the port's tensors on
    ``device`` (default CUDA), matrix weights in ``dtype`` (default
    ``cfg.dtype``)."""
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    out = {}
    for group, leaves in np_params.items():
        out[group] = {}
        for name, arr in leaves.items():
            t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
            dt = dtype if _takes_serving_dtype(group, name) else torch.float32
            out[group][name] = t.to(device=device, dtype=dt)
    return out


def params_to_numpy(params: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's parameter tree -> fp32 numpy arrays in the same layout."""
    return {group: {name: t.detach().float().cpu().numpy() for name, t in leaves.items()}
            for group, leaves in params.items()}
