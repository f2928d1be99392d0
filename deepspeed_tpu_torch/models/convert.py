"""The weights carrier between the two packages.

The TPU package's parameter tree and the port's share names and layout
(stacked ``[L, ...]`` blocks, weights ``[in, out]``), so conversion is a
name-for-name copy plus a dtype cast: matrix weights (and embeddings, and
the MoE experts ``moe_wi``/``moe_wg``/``moe_wo``) take the serving
``dtype``; norm scales, biases and the MoE gate ``gate_wg`` stay fp32. The TPU side hands
its tree over as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``.

``load_sparse_attention_params`` carries a ``BertSparseSelfAttention``'s
``query``/``key``/``value`` projections across the same way.

The trainable model keeps one tensor per layer (``per_layer=True``: blocks
become a list of L dicts); :func:`params_to_numpy` stacks them back. The
optimizer state moves the same way: ``mu`` and ``nu`` are parameter-shaped
trees, ``step`` the count of applied updates (:func:`optimizer_state_from_numpy`,
:func:`optimizer_state_to_numpy`), matched to the model's leaves by name.

:func:`tensor_parallel_shards` cuts a whole port tree into one
tensor-parallel rank's shards by the model's ``partition_rules``, so the
same weights go to the JAX engine whole and to each rank in pieces.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from .transformer import TensorParallel, TransformerConfig, resolve_device
from .transformer import takes_compute_dtype as _takes_serving_dtype


def params_from_jax(np_params: Dict[str, Any], cfg: TransformerConfig, device=None,
                    dtype=None, per_layer: bool = False) -> Dict[str, Any]:
    """numpy parameter tree (TPU package layout) -> the port's tensors on
    ``device`` (default CUDA), matrix weights in ``dtype`` (default
    ``cfg.dtype``; fp32 for training masters). ``per_layer``: blocks as a
    list of per-layer dicts (the trainable model's layout)."""
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    out = {}
    for group, leaves in np_params.items():
        out[group] = {}
        for name, arr in leaves.items():
            t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
            dt = dtype if _takes_serving_dtype(group, name) else torch.float32
            out[group][name] = t.to(device=device, dtype=dt)
    if per_layer:
        blocks = out["blocks"]
        out["blocks"] = [{name: t[l].clone() for name, t in blocks.items()}
                         for l in range(cfg.num_layers)]
    return out


def tensor_parallel_shards(params: Dict[str, Any], tp: TensorParallel) -> Dict[str, Any]:
    """A whole port tree (stacked or per-layer blocks) -> rank ``tp.rank``'s
    shards (``TensorParallel.shard``: the split leaves sliced, as copies;
    the replicated ones as they are). ``tp`` may carry no process group
    (``models.transformer.tensor_parallel(cfg, size=N, rank=r)``)."""
    out = {}
    for group, leaves in params.items():
        if isinstance(leaves, (list, tuple)):
            out[group] = [{name: tp.shard(group, name, t) for name, t in layer.items()}
                          for layer in leaves]
        else:
            out[group] = {name: tp.shard(group, name, t, stacked=group == "blocks")
                          for name, t in leaves.items()}
    return out


def load_sparse_attention_params(module, np_params: Dict[str, Any]) -> None:
    """Copy a ``BertSparseSelfAttention`` parameter tree in numpy (the JAX
    module's ``init``: ``{"query" | "key" | "value": {"kernel" [in, out],
    "bias"}}``) into the port's module of that class, name for name, on its
    device. Sparse attention adds no weights to ``TransformerLM``, so the
    model's own tree is unchanged."""
    mod_names = {n: sorted(getattr(module, n)) for n in ("query", "key", "value")}
    if {n: sorted(np_params.get(n, {})) for n in mod_names} != mod_names:
        raise ValueError(f"tree {sorted(np_params)} does not name the module's "
                         f"parameters {mod_names}")
    with torch.no_grad():
        for name in mod_names:
            for leaf, p in getattr(module, name).items():
                src = np.asarray(np_params[name][leaf], dtype=np.float32)
                if src.shape != tuple(p.shape):
                    raise ValueError(f"{name}/{leaf}: {src.shape} != {tuple(p.shape)}")
                p.copy_(torch.from_numpy(src.copy()))


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's parameter tree (stacked or per-layer blocks) -> fp32 numpy
    arrays in the TPU package's stacked layout."""
    def np32(t):
        return t.detach().float().cpu().numpy()

    out = {}
    for group, leaves in params.items():
        if isinstance(leaves, (list, tuple)):
            out[group] = {name: np.stack([np32(layer[name]) for layer in leaves])
                          for name in leaves[0]}
        else:
            out[group] = {name: np32(t) for name, t in leaves.items()}
    return out


def tree_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors of a port tree in the trainable model's parameter order
    (groups in order; per-layer blocks layer by layer)."""
    flat = []
    for leaves in params.values():
        for d in (leaves if isinstance(leaves, (list, tuple)) else [leaves]):
            flat.extend(d.values())
    return flat


def _leaves_like(np_tree: Dict[str, Any], like: Dict[str, Any]) -> List[np.ndarray]:
    """The arrays of a numpy tree in the TPU package's stacked layout, in the
    order of the port tree ``like`` (matched by name, so the two trees may
    list their leaves in different orders)."""
    names = {g: (list(v[0]) if isinstance(v, (list, tuple)) else list(v)) for g, v in like.items()}
    have = {g: sorted(v) for g, v in np_tree.items()}
    if have != {g: sorted(v) for g, v in names.items()}:
        raise ValueError(f"state tree {have} does not name the model's leaves "
                         f"{ {g: sorted(v) for g, v in names.items()} }")
    flat = []
    for group, leaves in like.items():
        if isinstance(leaves, (list, tuple)):
            for l, layer in enumerate(leaves):
                flat.extend(np.asarray(np_tree[group][name])[l] for name in layer)
        else:
            flat.extend(np.asarray(np_tree[group][name]) for name in leaves)
    return flat


def optimizer_state_from_numpy(engine, state: Dict[str, Any]) -> None:
    """Load ``{"step", "mu", "nu"}`` (numpy; ``mu``/``nu`` parameter-shaped
    trees in the TPU package's layout, e.g. the JAX engine's
    ``FusedAdamState`` or ``ScaleByAdamState``) into ``engine``'s Adam(W)
    state: the fused kernel's ``FusedAdamState`` or the optax-equivalent
    optimizer's. ``engine.module`` is a trainable ``TransformerLM``; leaves
    are matched to its parameters by name."""
    like = engine.module.params()
    mu_dst, nu_dst, step_dst = engine.adam_state()
    mu, nu = _leaves_like(state["mu"], like), _leaves_like(state["nu"], like)
    if len(mu) != len(mu_dst):
        raise ValueError(f"state has {len(mu)} leaves, the engine {len(mu_dst)}")
    with torch.no_grad():
        for dst, src in zip(mu_dst + nu_dst, mu + nu):
            if tuple(dst.shape) != src.shape:
                raise ValueError(f"state leaf {src.shape} != {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
        step_dst.fill_(int(np.asarray(state["step"])))


def optimizer_state_to_numpy(engine) -> Dict[str, Any]:
    """``engine``'s Adam(W) state as ``{"step", "mu", "nu"}`` numpy, the
    moments in the TPU package's stacked tree layout."""
    mu, nu, step = engine.adam_state()
    like = engine.module.params()

    def tree(flat):
        it = iter(flat)
        out = {}
        for group, leaves in like.items():
            if isinstance(leaves, (list, tuple)):
                out[group] = [{name: next(it) for name in layer} for layer in leaves]
            else:
                out[group] = {name: next(it) for name in leaves}
        return params_to_numpy(out)

    return {"step": np.int32(int(step)), "mu": tree(mu), "nu": tree(nu)}
