"""AutoTP: tensor-parallel specs inferred from parameter names, and the
numeric slicing they drive.

Counterpart of ``deepspeed_tpu/module_inject/auto_tp.py`` (reference
``deepspeed/module_inject/auto_tp.py:187``, ``ReplaceWithTensorSlicing:30``).
The JAX package turns the specs into shardings and lets XLA move the bytes;
here :meth:`AutoTP.shard` returns one rank's slices of each weight, the
port's counterpart of placing the arrays (also the way to build per-rank
checkpoints offline). A ``TransformerLM``'s own tensor-parallel forward
takes the slices of its ``partition_rules`` (``models.transformer``), which
also split the vocabulary and the biases; AutoTP's policies split the
matrices alone, as the reference's do.
"""

from typing import Dict, Optional

import torch

from ..parallel.mesh import MODEL_AXIS
from ..runtime.zero.partition import sanitize_spec
from .policies import POLICY_REGISTRY, TransformerPolicy


def _map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over a nested dict / list tree, paths 'a/0/b' (the
    reference's ``path_str``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


class AutoTP:

    def __init__(self, policy: Optional[type] = None, model_type: Optional[str] = None):
        if policy is None:
            policy = POLICY_REGISTRY.get((model_type or "").lower(), TransformerPolicy)
        self.policy = policy

    @staticmethod
    def kernel_supported(module_list):
        """Reference API: whether fused kernels exist for these modules. The
        port's attention kernels serve every dense transformer block."""
        return True

    def tree_specs(self, params) -> Dict:
        """The spec of every leaf (a tuple; replicated where no rule
        matches), in the tree's structure."""

        def spec(path, leaf):
            s = self.policy.spec_for(path, leaf.dim())
            return s if s is not None else (None, ) * leaf.dim()

        return _map_with_path(spec, params)

    def shard(self, params, rank: int, size: int):
        """Rank ``rank``'s slices of ``params`` over ``size`` model ranks:
        each leaf cut along its spec's ``model`` dim (copies), a dim that
        ``size`` does not divide left whole (``sanitize_spec``), replicated
        leaves as they are."""

        def cut(path, leaf):
            s = self.policy.spec_for(path, leaf.dim())
            if s is None:
                return leaf
            s = sanitize_spec(s, leaf.shape, {MODEL_AXIS: size}, path)
            if MODEL_AXIS not in s:
                return leaf
            d = s.index(MODEL_AXIS)
            n = leaf.shape[d] // size
            return leaf.narrow(d, rank * n, n).clone()

        return _map_with_path(cut, params)

    def partition_rules(self):
        return self.policy.partition_rules()


class ReplaceWithTensorSlicing:
    """Numeric slicing helper (reference class of the same name,
    ``auto_tp.py:30``): rank ``rank``'s slice of each weight."""

    def __init__(self, mp_group=None, mp_size: int = 1, out_dim: int = 1, in_dim: int = 0):
        self.mp_size = mp_size
        self.out_dim = out_dim
        self.in_dim = in_dim

    def _slice(self, w, axis, rank):
        n = w.shape[axis]
        assert n % self.mp_size == 0, \
            f"dim {axis} of {tuple(w.shape)} not divisible by mp_size {self.mp_size}"
        step = n // self.mp_size
        return w.narrow(axis, rank * step, step).contiguous().clone()

    def copy(self, dst_shape, src, rank: int = 0, int8: bool = False,
             allocate_tensor: bool = False):
        """Reference ``copy``: the slice of ``src`` that fills a destination
        of ``dst_shape`` (a column or row split, inferred)."""
        src = torch.as_tensor(src)
        if tuple(src.shape) == tuple(dst_shape):
            return src
        for axis in range(src.dim()):
            if (src.shape[axis] != dst_shape[axis]
                    and src.shape[axis] == dst_shape[axis] * self.mp_size):
                return self._slice(src, axis, rank)
        raise ValueError(f"cannot map src {tuple(src.shape)} onto dst {tuple(dst_shape)} at "
                         f"mp={self.mp_size}")

    def qkv_copy(self, dst_shape, src, rank: int = 0):
        """Fused-QKV aware copy (reference ``qkv_copy``): the fused dim is
        3 * hidden; each of q, k, v is sliced on its own, then re-fused."""
        src = torch.as_tensor(src)
        fused_axis = None
        for axis in range(src.dim()):
            if src.shape[axis] == dst_shape[axis] * self.mp_size:
                fused_axis = axis
                break
        if fused_axis is None:
            return src
        parts = src.chunk(3, dim=fused_axis)  # q, k, v
        return torch.cat([self._slice(p, fused_axis, rank) for p in parts], dim=fused_axis)
