"""Gradient-norm and clipping helpers.

Counterpart of ``deepspeed_tpu/runtime/utils.py``. The norms are device
tensors (one fused ``_foreach_norm`` launch over all tensors; over ZeRO
shards, one ``all_reduce`` of the local sum of squares), never read back to
the host, so a training step that clips stays asynchronous.
"""

from typing import Iterable, Sequence

import numpy as np
import torch

from .. import comm


def get_global_norm(norm_list: Iterable[float]) -> float:
    """l2-combine per-group norms (host floats)."""
    return float(np.sqrt(sum(float(n)**2 for n in norm_list)))


def global_norm(tensors: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """sqrt(sum of squares) over every element of ``tensors``, in fp32, as a
    device scalar (optax's ``global_norm``). ``group``: the tensors are this
    rank's shards of tensors split over the process group ``group``; the
    sum of squares is then one ``all_reduce`` of the local sum, on the
    device."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32 else t for t in tensors])
    if group is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    return comm.all_reduce(torch.stack(norms).square().sum(), group=group).sqrt()


def get_grad_norm(grads, norm_type: float = 2.0) -> torch.Tensor:
    """Global norm of a gradient list (``inf`` for the max norm)."""
    grads = [g for g in grads if g is not None]
    if norm_type == float("inf"):
        return torch.stack([g.abs().max().float() for g in grads]).max()
    if norm_type == 2.0:
        return global_norm(grads)
    return sum(g.float().abs().pow(norm_type).sum() for g in grads)**(1.0 / norm_type)


def clip_by_global_norm_(grads, max_norm: float, norm=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: each gradient becomes
    ``g`` when the global norm is below ``max_norm``, else
    ``(g / norm) * max_norm``. Returns the norm (a device scalar)."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    with torch.no_grad():
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def clip_grad_norm_(grads, max_norm: float, norm_type: float = 2.0) -> torch.Tensor:
    """The reference ``clip_grad_norm_``: scale every gradient in place by
    ``min(1, max_norm / (norm + 1e-6))``; returns the norm."""
    total = get_grad_norm(grads, norm_type)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    with torch.no_grad():
        torch._foreach_mul_([g for g in grads if g is not None], scale)
    return total
