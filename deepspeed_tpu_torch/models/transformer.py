"""Decoder-only transformer for the PyTorch port: config, parameters and the
shared numerics (norm, rotary, ALiBi slopes, MLP activation).

Counterpart of ``deepspeed_tpu/models/transformer.py``. Parameters keep the
TPU package's names, with weights stored ``[in, out]``, so a parameter tree
moves between the two packages name for name (``models/convert.py``). The
serving model keeps the stacked ``[L, ...]`` block layout
(``inference/v2``). The trainable model (``TransformerLM(...,
trainable=True)``) holds fp32 masters with one parameter per layer and
weight: in eager autograd, a select ``w[l]`` of a stacked tensor would write
a full-size zero gradient of the whole stack for every layer.

The training half (``forward``, ``loss_fn``, ``_chunked_ce_loss``) casts each
weight to ``cfg.dtype`` where it is used, as the TPU package does, so the
gradients land in fp32. Mixture-of-experts blocks (``moe_num_experts``)
train on the per-layer model, with both ``moe_impl``s: ``"grouped"`` through
the grouped matmul kernels, ``"einsum"`` through the one-hot dispatch as
plain products; the gating draws from an explicit ``torch.Generator``
(``loss(batch, generator=...)``). ``sparse_attention`` (the ds_config's
block, MHA only) sends every layer's training attention through the
block-sparse kernel (``ops/block_sparse_attention.py``). ``remat`` checkpoints
each block under ``remat_policy`` (``runtime/activation_checkpointing``), as
the JAX package wraps its block in ``jax.checkpoint``. Sequence parallelism
is not ported yet and is refused. ``dropout`` is refused above 0: the JAX
package declares the field (``deepspeed_tpu/models/transformer.py:84``) and
reads it nowhere, so its model has no dropout to port, and ignoring a
dropout asked for would train another model than the one asked for.

The v1 KV-cache path (``init_kv_cache``, ``forward_with_cache``, served by
``inference/engine.py``) keeps a dense ``[L, B, Smax, nkv, d]`` cache and,
on the card, attends through the paged kernels over that cache viewed as a
pool of 128-slot blocks with an identity block table
(:func:`cached_attention_route` decides). It serves MoE models, as the JAX
package's v1 path does; ``inference/v2``'s ragged forward runs dense MLPs
only. Block-sparse models are not served.

Tensor parallelism (the ``model`` mesh axis, :class:`TensorParallel`). The
JAX package states it as sharding rules (:func:`partition_rules`) and XLA
inserts the collectives; here every function below takes a ``tp`` plan and
this rank's shards of the weights, and gives the unsharded model's result
through Megatron's explicit regions (``module_inject/layers.py``): q/k/v
and ``w_up`` / ``w_gate`` (with their biases) are column-split, so each rank
runs ``num_heads / tp`` query and ``num_kv_heads / tp`` kv heads (RoPE, the
window and the ALiBi slopes of its own global heads) and ``F / tp`` of the
FFN; ``wo`` and ``w_down`` are row-split, their partial products summed
over the model group before ``bo`` / ``b_down`` are added once; the
embedding and the head are split over the vocabulary (a vocab-parallel
lookup, vocab-split logits, a vocab-parallel cross entropy: no rank builds
``[B, S, V]`` logits in the loss). A branch whose heads, kv heads or FFN
width ``tp`` does not divide runs replicated on every rank, and so do the
embedding and head where ``tp`` does not divide the vocabulary (the
reference's ``sanitize_spec`` fallback). Norms, ``bo`` and ``b_down`` are
replicated. ``tp=None`` is the unchanged single-rank path.
"""

import math
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import comm
from ..module_inject.layers import (copy_to_model_parallel_region, embedding_layer,
                                    gather_from_model_parallel_region, model_group,
                                    model_parallel_size, reduce_from_model_parallel_region,
                                    vocab_parallel_log_likelihood)
from ..moe.grouped import grouped_moe_ffn
from ..runtime.activation_checkpointing import checkpointing
from ..moe.sharded_moe import all_to_all, multiplicative_jitter, top1gating, top2gating
from ..parallel import groups
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..runtime.zero.partition import PartitionRules, sanitize_spec

# the weights matrix products read: stored in the serving dtype. Norm scales
# and biases stay fp32 (the norm runs in fp32 with its fp32 scale).
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate", "moe_wi", "moe_wg",
                  "moe_wo")
_EMBEDDINGS = {("embed", "embedding"), ("pos_embed", "embedding"), ("lm_head", "kernel")}


def takes_compute_dtype(group: str, name: str) -> bool:
    """Whether a leaf is stored in the serving dtype and cast to
    ``cfg.dtype`` wherever the training forward uses it: matrix weights,
    embeddings and the head (norm scales, biases and the MoE gate stay
    fp32)."""
    return (group, name) in _EMBEDDINGS or (group == "blocks" and name in MATMUL_WEIGHTS)


@dataclass
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: Optional[int] = None  # default 4x (gelu) or 8/3x (swiglu)
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None  # GQA; None = MHA
    max_seq_len: int = 2048
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    positions: str = "rotary"  # 'rotary' | 'learned' | 'alibi'
    mlp: str = "swiglu"  # 'swiglu' | 'gelu' | 'relu'
    use_bias: bool = False
    qkv_bias: Optional[bool] = None  # per-site override for q/k/v; None = use_bias
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    parallel_residual: bool = False
    shared_ln: bool = False
    rotary_dim: Optional[int] = None  # partial rotary; None = full head_dim
    embed_layernorm: bool = False
    dtype: Any = torch.bfloat16  # compute dtype
    # sequence-chunked cross entropy: the [B, loss_chunk, V] logits of one
    # chunk at a time (recomputed in the backward); None = full logits
    loss_chunk: Optional[int] = None
    attention_impl: str = "auto"  # 'auto' (flash on CUDA) | 'reference' | 'flash'
    # sliding-window attention (Mistral): query at i sees keys in (i-window, i]
    sliding_window: Optional[int] = None
    # mixture of experts (0 = dense); the TPU package's fields and defaults
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    moe_noisy_gate_policy: Optional[str] = None
    moe_impl: str = "einsum"  # 'einsum' (one-hot dispatch) | 'grouped' (grouped matmul)
    # block-sparse attention: the ds_config 'sparse_attention' dict (mode +
    # per-mode keys, reference config.py:289). None = dense attention.
    sparse_attention: Optional[dict] = None
    # activation checkpointing: each block recomputed in the backward, keeping
    # what remat_policy names (runtime/activation_checkpointing/checkpointing.py)
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    # refused (see _refuse_unported)
    sequence_parallel: bool = False
    dropout: float = 0.0

    def __post_init__(self):
        if self.moe_impl not in ("einsum", "grouped"):
            raise ValueError(f"moe_impl must be 'einsum' or 'grouped', got {self.moe_impl!r}")
        if self.intermediate_size is None:
            if self.mlp == "swiglu":
                self.intermediate_size = int(8 * self.hidden_size / 3 / 128 + 1) * 128
            else:
                self.intermediate_size = 4 * self.hidden_size
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.sparse_attention is not None:  # transformer.py:126-133
            if self.sliding_window is not None or self.positions == "alibi":
                raise NotImplementedError("sparse_attention does not compose with sliding_window "
                                          "or alibi (express the window via the layout instead)")
            if self.num_kv_heads != self.num_heads:
                raise NotImplementedError(
                    "sparse_attention requires num_kv_heads == num_heads (MHA) — reject at "
                    "config time rather than deep inside the first forward")
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a multiple of num_heads "
                             f"{self.num_heads}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple of num_kv_heads "
                             f"{self.num_kv_heads}")

    @property
    def qkv_bias_enabled(self) -> bool:
        return self.use_bias if self.qkv_bias is None else self.qkv_bias

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def refuse_moe_serving(cfg: TransformerConfig) -> None:
    """``inference.v2``'s ragged forward runs dense MLPs only."""
    if cfg.moe_num_experts > 0:
        raise NotImplementedError(
            "MoE (moe_num_experts) is not served by inference.v2: its ragged forward runs dense "
            "MLPs only, as the JAX v2 engine's flat model does; serve MoE models through "
            "init_inference (the v1 engine)")


def refuse_sparse_serving(cfg: TransformerConfig) -> None:
    """Serving a sparse-trained model with dense paged attention would use a
    distribution the model never saw: refused, as the JAX package refuses it
    (``transformer.py:859-864``, ``flat_model.py:84-88``)."""
    if cfg.sparse_attention is not None:
        raise NotImplementedError("sparse_attention serving is not implemented on the ragged "
                                  "plane; unset sparse_attention for inference")


def _refuse_unported(cfg: TransformerConfig) -> None:
    if cfg.sequence_parallel:
        raise NotImplementedError("TransformerConfig.sequence_parallel is not ported to the "
                                  "PyTorch package yet (ROADMAP A8)")
    if cfg.dropout:
        raise NotImplementedError(
            f"TransformerConfig.dropout={cfg.dropout}: the JAX package declares the field "
            f"(deepspeed_tpu/models/transformer.py:84) and reads it nowhere, so its model has no "
            f"dropout to port; refused rather than ignored")
    if cfg.remat:
        checkpointing.resolve_policy(cfg.remat_policy)  # ValueError names an unknown policy
    if cfg.attention_impl not in ("auto", "reference", "flash"):
        raise ValueError(f"attention_impl must be 'auto', 'reference' or 'flash', got "
                         f"{cfg.attention_impl!r}")


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on CUDA unless the caller asks for the
    CPU; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for (the default) but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Tensor parallelism: the partition rules and a rank's plan
# ---------------------------------------------------------------------------

def partition_rules(cfg: Optional[TransformerConfig] = None) -> PartitionRules:
    """Megatron's split over the ``model`` mesh axis (the reference's table,
    ``transformer.py:216-239``, in the port's names): q/k/v, ``w_up`` /
    ``w_gate`` and their biases column-split, ``wo`` / ``w_down`` row-split,
    the embedding and the head split over the vocabulary, the rest
    replicated. Specs are per layer (the reference's leading ``pipe`` entry
    of the stacked layer dim is dropped; ``tree_specs`` adds a None for a
    stacked tree)."""
    return PartitionRules([
        (r"embed/embedding", (MODEL_AXIS, None)),
        (r"pos_embed/embedding", (None, None)),
        (r"blocks/w[qkv]$", (None, MODEL_AXIS)),
        (r"blocks/b[qkv]$", (MODEL_AXIS, )),
        (r"blocks/wo$", (MODEL_AXIS, None)),
        (r"blocks/(w_up|w_gate)$", (None, MODEL_AXIS)),
        (r"blocks/b_up$", (MODEL_AXIS, )),
        (r"blocks/w_down$", (MODEL_AXIS, None)),
        (r"blocks/(ln1_scale|ln2_scale|ln1_bias|ln2_bias|b_down|bo)$", (None, )),
        (r"blocks/gate_wg$", (None, None)),
        (r"blocks/(moe_wi|moe_wg)$", (DATA_AXIS, None, MODEL_AXIS)),
        (r"blocks/moe_wo$", (DATA_AXIS, MODEL_AXIS, None)),
        (r"lm_head/kernel", (None, MODEL_AXIS)),
        (r"lm_head/bias", (MODEL_AXIS, )),
    ])


# the leaves of the three branches a plan splits as a whole or not at all
_ATTN_LEAVES = ("wq", "wk", "wv", "bq", "bk", "bv", "wo")
_MLP_LEAVES = ("w_up", "w_gate", "b_up", "w_down")
_VOCAB_LEAVES = (("embed", "embedding"), ("lm_head", "kernel"), ("lm_head", "bias"))


def _branch(group: str, name: str) -> Optional[str]:
    if group == "blocks":
        return "attn" if name in _ATTN_LEAVES else ("mlp" if name in _MLP_LEAVES else None)
    return "vocab" if (group, name) in _VOCAB_LEAVES else None


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place in the model group (``size`` ranks, this one
    ``rank``, over the process group ``group``; None for slicing alone) and
    which of a config's three branches it splits: ``attn`` (the query and
    kv heads), ``mlp`` (the FFN width), ``vocab`` (embedding rows, head
    columns). A branch ``size`` does not divide is replicated (see
    :func:`tensor_parallel`). ``rules``: the config's
    :func:`partition_rules`."""
    size: int
    rank: int
    group: Any
    attn: bool
    mlp: bool
    vocab: bool
    rules: PartitionRules = field(compare=False, repr=False)

    def split_dim(self, group: str, name: str, shape) -> Optional[int]:
        """The dim of a leaf (its per-layer ``shape``) split over the model
        group, or None where it is replicated: the rule's spec after
        :func:`sanitize_spec`, in a branch the plan splits."""
        branch = _branch(group, name)
        if branch is None or not getattr(self, branch):
            return None
        path = f"{group}/{name}"
        spec = sanitize_spec(self.rules.spec_for(path, len(shape)), shape,
                             {MODEL_AXIS: self.size}, path)
        return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None

    def shard(self, group: str, name: str, t: torch.Tensor, stacked: bool = False):
        """This rank's slice of the whole leaf ``t`` (a copy), or ``t``
        itself where the leaf is replicated. ``stacked``: ``t`` is ``[L,
        ...]``."""
        d = self.split_dim(group, name, t.shape[int(stacked):])
        if d is None:
            return t
        d += int(stacked)
        n = t.shape[d] // self.size
        return t.narrow(d, self.rank * n, n).clone()

    def heads(self, cfg: TransformerConfig) -> Tuple[int, int, int]:
        """(this rank's query heads, its kv heads, the global index of its
        first query head)."""
        n = self.size if self.attn else 1
        nq = cfg.num_heads // n
        return nq, cfg.num_kv_heads // n, (self.rank * nq if self.attn else 0)


def tensor_parallel(cfg: TransformerConfig, group=None, *, size: Optional[int] = None,
                    rank: int = 0) -> Optional["TensorParallel"]:
    """The plan of ``cfg`` over ``group`` (default: the current mesh's
    model group) or, with ``size``, over ``size`` ranks as ``rank`` with no
    process group (slicing alone). None at size 1. A branch whose sizes
    ``size`` does not divide (heads or kv heads; the FFN width; the
    vocabulary) runs replicated on every rank, with a warning: the
    reference's ``sanitize_spec`` fallback, applied to the whole branch so
    that a column split never feeds a replicated row weight. MoE blocks and
    block-sparse attention are refused under tensor parallelism (ROADMAP
    A3b, left open)."""
    if size is None:
        group = model_group(group)
        size = model_parallel_size(group)
        rank = comm.get_rank(group) if group is not None else 0
    if size == 1:
        return None
    _refuse_unported(cfg)
    if cfg.moe_num_experts > 0:
        raise NotImplementedError(
            f"MoE blocks at model size {size}: experts split over the model axis (the reference's "
            f"moe_wi / moe_wo specs and moe/mappings.py's token gather and drop) are ROADMAP A3b, "
            f"left open")
    if cfg.sparse_attention is not None:
        raise NotImplementedError(
            f"sparse_attention at model size {size}: per-head layouts sliced by head are ROADMAP "
            f"A3b, left open")
    attn = cfg.num_heads % size == 0 and cfg.num_kv_heads % size == 0
    mlp = cfg.intermediate_size % size == 0
    vocab = cfg.vocab_size % size == 0
    for ok, what in ((attn, f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads: attention"),
                     (mlp, f"FFN width {cfg.intermediate_size}: the MLP"),
                     (vocab, f"vocabulary {cfg.vocab_size}: the embedding and the head")):
        if not ok:
            warnings.warn(f"model size {size} does not divide the {what} runs replicated on "
                          f"every model rank")
    return TensorParallel(size, rank, group, attn, mlp, vocab, partition_rules(cfg))


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator], device=None,
                dtype=None, per_layer: bool = False,
                place: Optional[Callable[..., torch.Tensor]] = None) -> Dict[str, Any]:
    """Random parameters from ``generator`` (on ``device``), in the TPU
    package's names and stacked ``[L, ...]`` layout with the same scales.
    Matrix weights are stored in ``dtype`` (default ``cfg.dtype``), norm
    scales and biases in fp32. Drawn one layer at a time, so a full-size
    model never holds an fp32 copy of a stacked weight. ``per_layer``: the
    trainable layout, ``blocks`` a list of L per-layer dicts (same draws).

    ``place(group, name, tensor, stacked)`` takes each leaf as soon as it is
    made (a per-layer weight one layer at a time; ``stacked``: ``[L, ...]``)
    and returns what the tree keeps of it: tensor parallelism's broadcast
    from rank 0 and slice (:meth:`TransformerLM.__init__`), so that no rank
    holds the whole tree. ``generator=None`` draws nothing: the weights are
    left uninitialised for ``place`` to fill."""
    _refuse_unported(cfg)
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    L, H, Fi = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    place = place or (lambda group, name, t, stacked: t)

    def draw(shape):
        if generator is None:
            return torch.empty(shape, **f32)
        return torch.randn(shape, generator=generator, **f32)

    def dense(name, shape, fan_in, extra=1.0, dtype=dtype):
        if per_layer:
            return [place("blocks", name, draw(shape).mul_(1.0 / (math.sqrt(fan_in) * extra))
                          .to(dtype), False) for _ in range(L)]
        out = torch.empty((L, *shape), dtype=dtype, device=device)
        for l in range(L):
            w = draw(shape)
            out[l] = w.mul_(1.0 / (math.sqrt(fan_in) * extra))
        return place("blocks", name, out, True)

    def const(name, fill, shape):
        return place("blocks", name, fill((L, *shape), **f32), True)

    blocks = {
        "ln1_scale": const("ln1_scale", torch.ones, (H, )),
        "wq": dense("wq", (H, nq * d), H),
        "wk": dense("wk", (H, nkv * d), H),
        "wv": dense("wv", (H, nkv * d), H),
        "wo": dense("wo", (nq * d, H), nq * d, math.sqrt(2 * L)),
        "ln2_scale": const("ln2_scale", torch.ones, (H, )),
    }
    if cfg.moe_num_experts > 0:  # transformer.py:167-173
        E = cfg.moe_num_experts
        # the gate runs in fp32
        blocks["gate_wg"] = dense("gate_wg", (H, E), H, dtype=torch.float32)
        blocks["moe_wi"] = dense("moe_wi", (E, H, Fi), H)
        blocks["moe_wo"] = dense("moe_wo", (E, Fi, H), Fi, math.sqrt(2 * L))
        if cfg.mlp == "swiglu":
            blocks["moe_wg"] = dense("moe_wg", (E, H, Fi), H)
    else:
        blocks["w_up"] = dense("w_up", (H, Fi), H)
        blocks["w_down"] = dense("w_down", (Fi, H), Fi, math.sqrt(2 * L))
        if cfg.mlp == "swiglu":
            blocks["w_gate"] = dense("w_gate", (H, Fi), H)
    if cfg.parallel_residual and cfg.shared_ln:
        del blocks["ln2_scale"]
    if cfg.norm == "layernorm":
        blocks["ln1_bias"] = const("ln1_bias", torch.zeros, (H, ))
        if not (cfg.parallel_residual and cfg.shared_ln):
            blocks["ln2_bias"] = const("ln2_bias", torch.zeros, (H, ))
    if cfg.qkv_bias_enabled:
        blocks["bq"] = const("bq", torch.zeros, (nq * d, ))
        blocks["bk"] = const("bk", torch.zeros, (nkv * d, ))
        blocks["bv"] = const("bv", torch.zeros, (nkv * d, ))
    if cfg.use_bias:
        blocks["bo"] = const("bo", torch.zeros, (H, ))
        blocks["b_up"] = const("b_up", torch.zeros, (Fi, ))
        blocks["b_down"] = const("b_down", torch.zeros, (H, ))

    if per_layer:
        blocks = [{name: (t[l] if isinstance(t, list) else t[l].clone())
                   for name, t in blocks.items()} for l in range(L)]
    emb = draw((cfg.vocab_size, H)).mul_(0.02)
    params = {
        "embed": {"embedding": place("embed", "embedding", emb.to(dtype), False)},
        "blocks": blocks,
        "final_norm": {"scale": place("final_norm", "scale", torch.ones((H, ), **f32), False)},
    }
    if cfg.norm == "layernorm":
        params["final_norm"]["bias"] = place("final_norm", "bias", torch.zeros((H, ), **f32),
                                             False)
    if cfg.embed_layernorm:
        params["embed_norm"] = {"scale": place("embed_norm", "scale", torch.ones((H, ), **f32),
                                               False)}
        if cfg.norm == "layernorm":
            params["embed_norm"]["bias"] = place("embed_norm", "bias",
                                                 torch.zeros((H, ), **f32), False)
    if cfg.positions == "learned":
        pe = draw((cfg.max_seq_len, H)).mul_(0.02)
        params["pos_embed"] = {"embedding": place("pos_embed", "embedding", pe.to(dtype), False)}
    if not cfg.tie_embeddings:
        head = draw((H, cfg.vocab_size)).mul_(1.0 / math.sqrt(H))
        params["lm_head"] = {"kernel": place("lm_head", "kernel", head.to(dtype), False)}
    return params


# ---------------------------------------------------------------------------
# Shared numerics
# ---------------------------------------------------------------------------

def _norm(x, scale, bias, kind, eps):
    """RMSNorm / LayerNorm in fp32 with the fp32 scale, cast back to x's
    dtype (``transformer.py:246-255``)."""
    x32 = x.float()
    if kind == "rmsnorm":
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
        out = x32 * scale.float()
    else:
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).pow(2).mean(dim=-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float()
        if bias is not None:
            out = out + bias.float()
    return out.to(x.dtype)


def rope_table(cfg: TransformerConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sin, cos) of shape [S, r/2] for integer ``positions`` [S]."""
    d = cfg.rotary_dim or cfg.head_dim
    dev = positions.device
    inv_freq = 1.0 / (cfg.rope_theta**(torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    return torch.sin(freqs), torch.cos(freqs)


def apply_rope(x, sin, cos):
    """Half-split (not interleaved) rotary in fp32. x: [B, S, n, d]; sin/cos:
    [S, r/2] with r <= d: the first r dims rotate, the rest pass through."""
    r = 2 * sin.shape[-1]
    d = x.shape[-1]
    xr = x[..., :r] if r < d else x
    x1, x2 = xr.float().chunk(2, dim=-1)
    sinb = sin[None, :, None, :]
    cosb = cos[None, :, None, :]
    rot = torch.cat([x1 * cosb - x2 * sinb, x2 * cosb + x1 * sinb], dim=-1).to(x.dtype)
    if r < d:
        return torch.cat([rot, x[..., r:]], dim=-1)
    return rot


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes: powers of two for power-of-two head counts,
    the standard interleave otherwise."""

    def pow2_slopes(n):
        start = 2.0**(-(2.0**-(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2_slopes(n_heads), np.float32)
    closest = 2**int(math.floor(math.log2(n_heads)))
    out = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][:n_heads - closest]
    return np.asarray(out + extra, np.float32)


def mlp_activation(cfg: TransformerConfig, up, gate=None):
    """swiglu: silu(gate) * up; relu; gelu with the tanh approximation (the
    TPU package's ``jax.nn.gelu`` default)."""
    if cfg.mlp == "swiglu":
        return F.silu(gate) * up
    if cfg.mlp == "relu":
        return F.relu(up)
    return F.gelu(up, approximate="tanh")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, causal=True, window=None, alibi=None):
    """fp32 einsum attention (``transformer.py:298``), differentiable by
    autograd. ``window``: query i sees keys in (i - window, i]. ``alibi``:
    per-head slopes [nq]; adds ``slope * (k_pos - q_pos)``."""
    B, S, nq, d = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    qf = (q.float() / math.sqrt(d)).reshape(B, S, nkv, group, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    pos = torch.arange(S, device=q.device)
    if alibi is not None:
        rel = (pos[None, :] - pos[:, None]).float()
        slopes = torch.as_tensor(alibi, dtype=torch.float32, device=q.device)
        scores = scores + slopes.reshape(nkv, group)[:, :, None, None] * rel
    if causal:
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask = mask & (pos[:, None] - pos[None, :] < int(window))
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return ctx.reshape(B, S, nq, d).to(q.dtype)


_SPARSE_LAYOUT_CACHE = {}


def _sparse_layout(cfg: TransformerConfig, nq: int, S: int, device):
    """(block, causal, layout, lut, nvalid) of the config's sparsity layout
    at ``S``, the LUT as int32 tensors on ``device``: built and copied there
    once per (config, heads, S, device)."""
    key = (repr(sorted(cfg.sparse_attention.items())), nq, S, str(device))
    if key not in _SPARSE_LAYOUT_CACHE:
        from ..ops.sparse_attention import build_sparsity_config, make_layout_lut

        sc = build_sparsity_config(cfg.sparse_attention, nq)
        layout = sc.make_layout(S)
        causal = getattr(sc, "attention", "bidirectional") == "unidirectional"
        if not causal:
            warnings.warn("sparse_attention layout is BIDIRECTIONAL: next-token training would "
                          "see future tokens. Set attention='unidirectional' in the sparsity "
                          "config unless this is an encoder-style objective.")
        lut, nvalid = make_layout_lut(layout)
        _SPARSE_LAYOUT_CACHE[key] = (sc.block, causal, layout,
                                     torch.as_tensor(lut, device=device),
                                     torch.as_tensor(nvalid, device=device))
    return _SPARSE_LAYOUT_CACHE[key]


def _sparse_attention(cfg: TransformerConfig, q, k, v):
    """Block-sparse training attention configured by the ds_config's
    ``sparse_attention`` block (``transformer.py:337-368``); causality
    follows the layout's ``attention`` type. The [B, S, n, d] tensors go to
    the kernel as [B, n, S, d] views (read through their strides), and its
    output comes back as a view of a [B, S, n, d] buffer."""
    B, S, nq, d = q.shape
    assert k.shape[2] == nq, "MHA enforced at config time (TransformerConfig.__post_init__)"
    block, causal, layout, lut, nvalid = _sparse_layout(cfg, nq, S, q.device)
    from ..ops.block_sparse_attention import block_sparse_attention

    ctx = block_sparse_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 layout, block, causal=causal, lut=lut, nvalid=nvalid)
    return ctx.transpose(1, 2)


def _attention(cfg: TransformerConfig, q, k, v, head0: int = 0):
    """``sparse_attention`` takes the block-sparse path; else
    ``attention_impl`` 'auto' takes the flash kernels on CUDA tensors and
    the einsum reference elsewhere (``transformer.py:371``). ``head0``: the
    global index of q's first head (a tensor-parallel rank's), whose ALiBi
    slopes it takes."""
    if cfg.sparse_attention is not None:
        return _sparse_attention(cfg, q, k, v)
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    alibi = cfg.positions == "alibi"
    nq = q.shape[2]
    if impl == "flash":
        from ..ops.flash_attention import flash_attention, slope_table

        if alibi and nq != cfg.num_heads:
            alibi = slope_table(cfg.num_heads, q.device)[head0:head0 + nq]
        return flash_attention(q, k, v, causal=True, window=cfg.sliding_window, alibi=alibi)
    return reference_attention(q, k, v, causal=True, window=cfg.sliding_window,
                               alibi=alibi_slopes(cfg.num_heads)[head0:head0 + nq]
                               if alibi else None)


def _attn_branch(cfg: TransformerConfig, layer, h, sin, cos, attend=None, tp=None):
    """Attention sub-block on pre-normed input ``h`` [B, S, H]. ``attend(q,
    k, v)`` -> [B, S, nq, d] (default :func:`_attention`; the KV-cache
    forward passes one that writes the cache and attends over it). ``tp``
    splitting attention: ``layer`` holds this rank's heads' columns of
    q/k/v and rows of ``wo``; ``h`` enters the model region and the output
    is summed over the model group before ``bo``."""
    dt = cfg.dtype
    B, S, H = h.shape
    split = tp is not None and tp.attn
    nq, nkv, head0 = tp.heads(cfg) if split else (cfg.num_heads, cfg.num_kv_heads, 0)
    d = cfg.head_dim
    if split:
        h = copy_to_model_parallel_region(h, tp.group)
    q = h @ layer["wq"].to(dt)
    k = h @ layer["wk"].to(dt)
    v = h @ layer["wv"].to(dt)
    if cfg.qkv_bias_enabled:
        q = q + layer["bq"].to(dt)
        k = k + layer["bk"].to(dt)
        v = v + layer["bv"].to(dt)
    q = q.reshape(B, S, nq, d)
    k = k.reshape(B, S, nkv, d)
    v = v.reshape(B, S, nkv, d)
    if cfg.positions == "rotary":
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    ctx = (_attention(cfg, q, k, v, head0) if attend is None else
           attend(q, k, v)).reshape(B, S, nq * d)
    # named for remat_policy="save_only_these_names(attn_out)" (transformer.py:502-507)
    ctx = checkpointing.checkpoint_name("attn_out", ctx)
    out = ctx @ layer["wo"].to(dt)
    if split:
        out = reduce_from_model_parallel_region(out, tp.group)
    if cfg.use_bias:
        out = out + layer["bo"].to(dt)
    return out


def _mlp_branch(cfg: TransformerConfig, layer, h, generator=None, tp=None):
    """MLP (dense or MoE) sub-block on pre-normed input ``h``. Returns (out,
    the MoE layer's aux loss or None). ``tp`` splitting the MLP: ``layer``
    holds this rank's FFN columns of ``w_up`` / ``w_gate`` and rows of
    ``w_down``; the output is summed over the model group before
    ``b_down``."""
    if cfg.moe_num_experts > 0:
        return _moe_mlp(cfg, layer, h, generator)
    dt = cfg.dtype
    split = tp is not None and tp.mlp
    if split:
        h = copy_to_model_parallel_region(h, tp.group)
    up = h @ layer["w_up"].to(dt)
    if cfg.use_bias:
        up = up + layer["b_up"].to(dt)
    if cfg.mlp == "swiglu":
        act = mlp_activation(cfg, up, h @ layer["w_gate"].to(dt))
    else:
        act = mlp_activation(cfg, up)
    down = act @ layer["w_down"].to(dt)
    if split:
        down = reduce_from_model_parallel_region(down, tp.group)
    if cfg.use_bias:
        down = down + layer["b_down"].to(dt)
    return down, None


def _expert_ffn(cfg: TransformerConfig, layer, x):
    """The experts' FFN on their capacity slots ``x`` [..., E, C, M] (one
    weight slice a slot row's expert) as batched products."""
    dt = cfg.dtype
    up = torch.einsum("...ecm,emf->...ecf", x, layer["moe_wi"].to(dt))
    gate = (torch.einsum("...ecm,emf->...ecf", x, layer["moe_wg"].to(dt))
            if cfg.mlp == "swiglu" else None)
    return torch.einsum("...ecf,efm->...ecm", mlp_activation(cfg, up, gate),
                        layer["moe_wo"].to(dt))


def _moe_mlp(cfg: TransformerConfig, layer, h, generator=None):
    """MoE FFN (``transformer.py:557``): top-k capacity gating per batch row
    (the TPU package's ``vmap`` over rows: each row's capacity counts that
    row's tokens), then the grouped matmul path or the one-hot einsum path.
    ``generator``: one ``torch.Generator`` for every row, or a sequence of
    one a row (each row's jitter, token priority and Gumbel noise drawn from
    its own), or None (no draws).

    Expert parallelism: weights holding ``E / ep`` experts (this rank's, of
    a ZeRO partition over the ``ep`` ranks of the data group) take the
    einsum path's slots to their owners and back by an all-to-all over
    ``groups.get_expert_parallel_group()``, the reference's sharding flip
    ``P(None, DATA)`` <-> ``P(BATCH_AXES)`` (``transformer.py:602-616``). The
    grouped path takes every expert (the partition gathers them).
    Returns (out [B, S, H], the rows' mean l_aux)."""
    dt = cfg.dtype
    B, S, H = h.shape
    E = cfg.moe_num_experts
    gens = list(generator) if isinstance(generator, (list, tuple)) else [generator] * B
    gate_in = h.float()
    if cfg.moe_noisy_gate_policy == "Jitter" and gens[0] is not None:
        gate_in = torch.stack([multiplicative_jitter(gate_in[b], gens[b]) for b in range(B)])
    logits = torch.einsum("bsh,he->bse", gate_in, layer["gate_wg"].float())

    def gate_row(lg, gen):
        if cfg.moe_top_k == 1:
            return top1gating(lg, cfg.moe_capacity_factor, cfg.moe_min_capacity,
                              noisy_gate_policy=cfg.moe_noisy_gate_policy, generator=gen,
                              use_rts=gen is not None)[:3]
        return top2gating(lg, cfg.moe_capacity_factor, cfg.moe_min_capacity, generator=gen)[:3]

    rows = [gate_row(logits[b], gens[b]) for b in range(B)]
    l_aux = torch.stack([r[0] for r in rows]).mean()
    combine = torch.stack([r[1] for r in rows])  # [B, S, E, C]
    E_loc = layer["moe_wi"].shape[0]
    if cfg.moe_impl == "grouped":
        if E_loc != E:
            raise ValueError(f"the grouped MoE path takes all {E} experts, got {E_loc}: gather "
                             f"them first (ZeroPartition.gather(..., whole_experts=True))")
        w_se = combine.sum(dim=3).reshape(B * S, E).to(dt)
        y = grouped_moe_ffn(h.reshape(B * S, H), w_se, layer["moe_wi"], layer["moe_wo"],
                            top_k=cfg.moe_top_k,
                            wg=layer.get("moe_wg") if cfg.mlp == "swiglu" else None,
                            activation=lambda up, gate: mlp_activation(cfg, up, gate))
        return y.reshape(B, S, H), l_aux
    dispatch = torch.stack([r[2] for r in rows])
    dispatched = torch.einsum("bsec,bsm->becm", dispatch.to(dt), h)
    if E_loc == E:
        expert_out = _expert_ffn(cfg, layer, dispatched)
    else:
        group = groups.get_expert_parallel_group()
        ep = E // E_loc
        if E_loc * ep != E or comm.get_world_size(group) != ep:
            raise ValueError(f"{E_loc} of {E} experts a rank over an expert group of "
                             f"{comm.get_world_size(group)} ranks")
        C = dispatched.shape[2]
        # [ep, B, E_loc, C, M]: chunk j (rank j's experts) to rank j, which
        # gets back its experts' slots from every rank (dim 0 the sender)
        slots = all_to_all(dispatched.reshape(B, ep, E_loc, C, H).transpose(0, 1), group)
        out = _expert_ffn(cfg, layer, slots)
        expert_out = all_to_all(out, group).transpose(0, 1).reshape(B, E, C, H)
    return torch.einsum("bsec,becm->bsm", combine.to(dt), expert_out), l_aux


def _block(cfg: TransformerConfig, x, layer, sin, cos, generator=None, attend=None, tp=None):
    """One transformer block on this layer's weights (``transformer.py:534``;
    ``parallel_residual``: attention and MLP read the same input). Returns
    (x, the MoE aux loss or None)."""
    h1 = _norm(x, layer["ln1_scale"], layer.get("ln1_bias"), cfg.norm, cfg.norm_eps)
    attn_out = _attn_branch(cfg, layer, h1, sin, cos, attend, tp)
    if cfg.parallel_residual:
        h2 = h1 if cfg.shared_ln else _norm(x, layer["ln2_scale"], layer.get("ln2_bias"),
                                            cfg.norm, cfg.norm_eps)
        mlp_out, aux = _mlp_branch(cfg, layer, h2, generator, tp)
        return x + attn_out + mlp_out, aux
    x = x + attn_out
    h2 = _norm(x, layer["ln2_scale"], layer.get("ln2_bias"), cfg.norm, cfg.norm_eps)
    mlp_out, aux = _mlp_branch(cfg, layer, h2, generator, tp)
    return x + mlp_out, aux


class GatheredLayers:
    """The blocks of a ZeRO-3 forward (``TransformerLM.gathered_params``):
    indexing (or iterating) gathers a layer's weights when the layer loop
    reaches it, so one layer's gathered weights are alive at a time (what
    autograd saves of them is gathered again in the backward; under remat
    the recompute gathers them again)."""

    def __init__(self, n: int, gather):
        self.n = n
        self._gather = gather

    def __len__(self):
        return self.n

    def __getitem__(self, l: int):
        return self._gather(l)

    def __iter__(self):
        return (self._gather(l) for l in range(self.n))


def layers(blocks: Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]], GatheredLayers],
           n: int):
    """Per-layer weight dicts of a stacked ``{name: [L, ...]}`` tree or of a
    per-layer list (a ``GatheredLayers`` gathers them one at a time)."""
    if isinstance(blocks, GatheredLayers):
        return blocks
    if isinstance(blocks, (list, tuple)):
        return list(blocks)
    return [{name: t[l] for name, t in blocks.items()} for l in range(n)]


def _embed(cfg: TransformerConfig, params, ids, tp=None):
    """Token ids -> embedding rows in ``cfg.dtype``: a vocab-parallel lookup
    (``embedding_layer``) where ``tp`` splits the vocabulary."""
    emb = params["embed"]["embedding"].to(cfg.dtype)
    if tp is not None and tp.vocab:
        return embedding_layer(ids, emb, tp.group)
    return emb[ids]


def forward_hidden(cfg: TransformerConfig, params, input_ids, generator=None, tp=None):
    """Token ids [B, S] -> (final-norm hidden [B, S, H], the MoE aux loss
    summed over layers; 0 for a dense model): the plain layer loop of
    ``transformer.py:645``. ``generator`` feeds the gating's draws (None:
    deterministic routing). ``tp``: ``params`` are this rank's shards
    (module docstring); the hidden states are whole on every rank.

    ``cfg.remat``: each block runs under ``checkpointing.checkpoint`` with
    ``cfg.remat_policy`` (``transformer.py:669-671``). The checkpointed
    function takes the layer's index and fetches its weights itself, so a
    ZeRO-3 gather (``GatheredLayers``) happens inside it: the forward's
    gathered weights die with the layer, the recompute gathers them again,
    and the gradient's reduce-scatter runs once, from the forward's
    gather. The generators are its arguments, so the gating's draws replay
    in the recompute; a tensor-parallel recompute runs the block's
    all-reduces again, in the same order on every rank."""
    dt = cfg.dtype
    B, S = input_ids.shape
    x = _embed(cfg, params, input_ids, tp)
    if cfg.positions == "learned":
        x = x + params["pos_embed"]["embedding"].to(dt)[:S][None]
    if cfg.embed_layernorm:
        en = params["embed_norm"]
        x = _norm(x, en["scale"], en.get("bias"), cfg.norm, cfg.norm_eps)
    sin = cos = None
    if cfg.positions == "rotary":
        sin, cos = rope_table(cfg, torch.arange(S, device=input_ids.device))
    blocks = layers(params["blocks"], cfg.num_layers)

    def block(x, l, generator):
        return _block(cfg, x, blocks[l], sin, cos, generator, tp=tp)

    policy = checkpointing.resolve_policy(cfg.remat_policy) if cfg.remat else None
    auxs = []
    for l in range(cfg.num_layers):
        if policy is None:
            x, aux = block(x, l, generator)
        else:
            x, aux = checkpointing.checkpoint(block, x, l, generator, policy=policy)
        if aux is not None:
            auxs.append(aux)
    fn = params["final_norm"]
    moe_aux = torch.stack(auxs).sum() if auxs else torch.zeros((), device=x.device)
    return _norm(x, fn["scale"], fn.get("bias"), cfg.norm, cfg.norm_eps), moe_aux


def _unembed(cfg: TransformerConfig, params, x, tp=None):
    """Final hidden [..., H] -> vocabulary logits [..., V] in fp32; where
    ``tp`` splits the vocabulary, this rank's slice ``[..., V / tp]`` (``x``
    enters the model region; tied embeddings use the same vocab-split
    table)."""
    dt = cfg.dtype
    if tp is not None and tp.vocab:
        x = copy_to_model_parallel_region(x, tp.group)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].to(dt).t()
    else:
        logits = x @ params["lm_head"]["kernel"].to(dt)
        if "bias" in params["lm_head"]:
            logits = logits + params["lm_head"]["bias"].to(logits.dtype)
    return logits.float()


def forward_with_aux(cfg: TransformerConfig, params, input_ids, generator=None, tp=None):
    """Token ids [B, S] -> (logits [B, S, V] fp32, the MoE aux loss); where
    ``tp`` splits the vocabulary, this rank's slice of the logits."""
    x, moe_aux = forward_hidden(cfg, params, input_ids, generator, tp)
    return _unembed(cfg, params, x, tp), moe_aux


def _whole_logits(logits, tp=None):
    """Vocab-split logits gathered over the model group (every rank then
    holds the same ``[..., V]``); others as they are."""
    if tp is not None and tp.vocab:
        return gather_from_model_parallel_region(logits, tp.group)
    return logits


def forward(cfg: TransformerConfig, params, input_ids, tp=None):
    """Token ids [B, S] -> logits [B, S, V] (fp32), whole on every rank."""
    return _whole_logits(forward_with_aux(cfg, params, input_ids, tp=tp)[0], tp)


# ---------------------------------------------------------------------------
# KV-cache inference path (the v1 engine; transformer.py:785-922)
# ---------------------------------------------------------------------------

# the block of the identity table that views a dense cache as a paged pool:
# sequence b owns the pool's blocks b * nb .. b * nb + nb - 1, nb = Smax / 128
V1_BLOCK = 128


def init_kv_cache(cfg: TransformerConfig, batch_size: int, max_len: int, dtype=None, device=None,
                  tp=None):
    """An empty cache of ``max_len`` positions per sequence: zeroed ``k`` /
    ``v`` [L, B, max_len, nkv, d] in ``dtype`` (default ``cfg.dtype``) on
    ``device`` (default CUDA), and ``length``, the positions filled, a host
    int (so no step reads it from the device). ``tp`` splitting attention:
    nkv is this rank's kv heads."""
    dtype = cfg.dtype if dtype is None else dtype
    device = resolve_device(device)
    nkv = tp.heads(cfg)[1] if tp is not None else cfg.num_kv_heads
    shape = (cfg.num_layers, batch_size, max_len, nkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "length": 0}


def cached_attention_route(impl: str, device_type: str, cache_dtype, nq: int, nkv: int, d: int,
                           smax: int) -> str:
    """The KV-cache forward's attention route (the counterpart of
    ``_use_fused_decode``, ``transformer.py:835-853``): ``"paged"``, the paged
    kernels over the cache viewed as a pool of ``V1_BLOCK``-slot blocks, or
    ``"dense"``, the fp32 einsum over the whole cache. ``"reference"`` is
    always dense, ``"auto"`` dense on a CPU cache; every other case is paged
    (on CPU tensors the kernel wrappers run their plain versions). A paged
    cache must be ``smax`` a multiple of ``V1_BLOCK`` long, and on the card
    bf16 with head_dim 64 or 128 and at most 8 query heads a kv head, the
    kernels' limits; else ValueError names every miss."""
    if impl == "reference" or (impl == "auto" and device_type != "cuda"):
        return "dense"
    misses = []
    if smax % V1_BLOCK:
        misses.append(f"cache length {smax} (a multiple of {V1_BLOCK} is viewed as blocks)")
    if device_type == "cuda":
        if cache_dtype != torch.bfloat16:
            misses.append(f"cache dtype {cache_dtype} (the kernels take bfloat16)")
        if d not in (64, 128):
            misses.append(f"head_dim {d} (the kernels take 64 and 128)")
        if nq % nkv or nq // nkv > 8:
            misses.append(f"{nq} query heads over {nkv} kv heads (the decode takes up to 8 a "
                          f"kv head)")
    if misses:
        raise ValueError(f"the paged KV-cache attention on {device_type} does not take "
                         + "; ".join(misses) + "; attention_impl='reference' serves through "
                         "the dense einsum")
    return "paged"


def _head_slopes(cfg: TransformerConfig, head0: int, nq: int):
    """The ALiBi slopes of heads ``head0 .. head0 + nq - 1`` (a
    tensor-parallel rank's slice of the whole model's), or None."""
    return alibi_slopes(cfg.num_heads)[head0:head0 + nq] if cfg.positions == "alibi" else None


def _paged_descriptors(cfg: TransformerConfig, cache, B: int, T: int, start: int, head0: int = 0):
    """The paged route's inputs shared by every layer of one call: the
    identity block table (built once per cache), ``seq_idx`` and ``pos`` of
    the call's B x T tokens and the ALiBi slopes of the cache's query heads
    from ``head0`` on, all on the cache's device (so the prefill's tile
    descriptors are computed once per call)."""
    dev = cache["k"].device
    i32 = dict(dtype=torch.int32, device=dev)
    if "tables" not in cache:
        nb = cache["k"].shape[2] // V1_BLOCK
        cache["tables"] = torch.arange(B, **i32)[:, None] * nb + torch.arange(nb, **i32)[None, :]
    seq_idx = torch.arange(B, **i32).repeat_interleave(T)
    pos = torch.arange(start, start + T, **i32).repeat(B)
    nq = cfg.num_heads * cache["k"].shape[3] // cfg.num_kv_heads
    slopes = _head_slopes(cfg, head0, nq)
    return cache["tables"], seq_idx, pos, (torch.as_tensor(slopes, device=dev)
                                           if slopes is not None else None)


def _cached_attention(cfg: TransformerConfig, q, ck, cv, start: int, route: str, desc=None,
                      head0: int = 0):
    """q [B, T, nq, d] at positions ``start`` .. ``start + T - 1`` over one
    layer's cache ``ck`` / ``cv`` [B, Smax, nkv, d], whose positions below
    ``start + T`` hold keys and values -> [B, T, nq, d] in q's dtype. The
    paged route hands the cache, viewed (not copied) as a pool of
    ``B * Smax`` slots, to ``ops.paged_attention.paged_attention`` with the
    identity table of ``desc``; the dense route is the reference's einsum
    (``transformer.py:819-832``). Both mask every position past the query's,
    so positions past ``start + T`` never count. ``head0``: the global index
    of q's first head (its ALiBi slope)."""
    B, T, nq, d = q.shape
    Smax, nkv = ck.shape[1], ck.shape[2]
    if route == "paged":
        from ..ops.paged_attention import paged_attention

        tables, seq_idx, pos, slopes = desc
        ctx = paged_attention(q.reshape(B * T, nq, d), ck.view(B * Smax, nkv, d),
                              cv.view(B * Smax, nkv, d), tables, seq_idx, pos, V1_BLOCK,
                              window=cfg.sliding_window, alibi=slopes)
        return ctx.reshape(B, T, nq, d)
    g = nq // nkv
    qf = q.float().reshape(B, T, nkv, g, d) / math.sqrt(d)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, ck.float())
    k_pos = torch.arange(Smax, device=q.device)[None, :]
    q_pos = (start + torch.arange(T, device=q.device))[:, None]
    if cfg.positions == "alibi":
        slopes = torch.as_tensor(_head_slopes(cfg, head0, nq), device=q.device).reshape(nkv, g)
        scores = scores + slopes[None, :, :, None, None] * (k_pos - q_pos).float()
    mask = (k_pos <= q_pos) & (k_pos < start + T)
    if cfg.sliding_window is not None:
        mask = mask & (q_pos - k_pos < int(cfg.sliding_window))
    probs = torch.softmax(torch.where(mask, scores, torch.full_like(scores, -1e30)), dim=-1)
    ctx = torch.einsum("bkgts,bskd->btkgd", probs, cv.float())
    return ctx.reshape(B, T, nq, d).to(q.dtype)


def forward_with_cache(cfg: TransformerConfig, params, input_ids, cache, tp=None):
    """Prefill or decode step (``transformer.py:856-922``): the tokens
    ``input_ids`` [B, T] at positions ``length`` .. ``length + T - 1`` run
    through every layer, each writing its k / v into the cache in place
    before attending over it. Returns (fp32 logits [B, T, V], the cache with
    ``length`` advanced by T; the same dict). ``params["blocks"]`` may be the
    stacked serving tree or a per-layer list. MoE blocks route without draws
    (the deterministic gating of inference). ``tp``: ``params`` are this
    rank's shards and the cache holds its kv heads
    (``init_kv_cache(..., tp=tp)``); the logits are gathered whole on every
    rank."""
    logits, cache = _forward_with_cache(cfg, params, input_ids, cache, tp)
    return _whole_logits(logits, tp), cache


def _forward_with_cache(cfg: TransformerConfig, params, input_ids, cache, tp=None):
    """:func:`forward_with_cache` with the logits of this rank's vocabulary
    slice where ``tp`` splits it."""
    if cfg.sparse_attention is not None:
        # serving a sparse-trained model with dense cached attention would
        # use a distribution the model never saw (transformer.py:859-865)
        raise NotImplementedError("sparse_attention serving is not implemented: the KV-cache "
                                  "decode applies dense attention; unset sparse_attention "
                                  "for inference")
    dt = cfg.dtype
    B, T = input_ids.shape
    start = int(cache["length"])
    ck_all, cv_all = cache["k"], cache["v"]
    L, _, Smax, nkv, d = ck_all.shape
    if start + T > Smax:
        raise ValueError(f"the cache holds {Smax} positions; {start} filled + {T} new exceed it")
    ids = input_ids.to(ck_all.device).long()
    x = _embed(cfg, params, ids, tp)
    if cfg.positions == "learned":
        x = x + params["pos_embed"]["embedding"].to(dt)[start:start + T][None]
    if cfg.embed_layernorm:
        en = params["embed_norm"]
        x = _norm(x, en["scale"], en.get("bias"), cfg.norm, cfg.norm_eps)
    sin = cos = None
    if cfg.positions == "rotary":
        sin, cos = rope_table(cfg, torch.arange(start, start + T, device=ck_all.device))
    nq, want_nkv, head0 = tp.heads(cfg) if tp is not None else (cfg.num_heads, nkv, 0)
    if nkv != want_nkv:
        raise ValueError(f"the cache holds {nkv} kv heads a layer, this rank's attention "
                         f"{want_nkv}: build it with init_kv_cache(..., tp=tp)")
    route = cached_attention_route(cfg.attention_impl, ck_all.device.type, ck_all.dtype,
                                   nq, nkv, d, Smax)
    desc = _paged_descriptors(cfg, cache, B, T, start, head0) if route == "paged" else None
    for l, layer in enumerate(layers(params["blocks"], L)):
        ck, cv = ck_all[l], cv_all[l]

        def attend(q, k, v, ck=ck, cv=cv):
            ck[:, start:start + T] = k
            cv[:, start:start + T] = v
            return _cached_attention(cfg, q, ck, cv, start, route, desc, head0)

        x, _ = _block(cfg, x, layer, sin, cos, attend=attend, tp=tp)
    fn = params["final_norm"]
    x = _norm(x, fn["scale"], fn.get("bias"), cfg.norm, cfg.norm_eps)
    cache["length"] = start + T
    return _unembed(cfg, params, x, tp), cache


def _ce_aux(batch, input_ids):
    """The CE targets of a batch: its 'labels', else the shifted input, plus
    an optional 'loss_mask'."""
    aux = {}
    if isinstance(batch, dict) and "labels" in batch:
        aux["labels"] = batch["labels"]
    else:
        aux["shift_ids"] = input_ids
    if isinstance(batch, dict) and "loss_mask" in batch:
        aux["loss_mask"] = batch["loss_mask"]
    return aux


def ce_count(batch) -> torch.Tensor:
    """The count :func:`_ce_loss` divides a batch's summed log-likelihood
    by, before its clamp at 1: the ``loss_mask``'s sum over the positions
    scored, else the number of positions scored. An fp32 device scalar."""
    input_ids = batch["input_ids"] if isinstance(batch, dict) else batch
    aux = _ce_aux(batch, input_ids)
    scored = input_ids.shape[-1] if "labels" in aux else input_ids.shape[-1] - 1
    if "loss_mask" in aux:
        return aux["loss_mask"][..., :scored].float().sum()
    return torch.full((), float(input_ids[..., :scored].numel()), device=input_ids.device)


def _token_ll(logits, labels, tp=None):
    """log softmax(logits)[label] per position; vocab-parallel
    (``vocab_parallel_log_likelihood``) where ``tp`` splits the vocabulary
    and ``logits`` are this rank's slice."""
    if tp is not None and tp.vocab:
        return vocab_parallel_log_likelihood(logits, labels, tp.group)
    return torch.gather(torch.log_softmax(logits, dim=-1), -1, labels[..., None].long())[..., 0]


def _ce_loss(logits, aux, tp=None):
    """Next-token cross entropy (masked mean with a 'loss_mask'). ``tp``
    splitting the vocabulary: ``logits`` are this rank's slice."""
    if "labels" in aux:
        shift_logits, labels = logits, aux["labels"]
    else:
        shift_logits, labels = logits[..., :-1, :], aux["shift_ids"][..., 1:]
    token_ll = _token_ll(shift_logits, labels, tp)
    if "loss_mask" in aux:
        mask = aux["loss_mask"][..., :token_ll.shape[-1]].float()
        return -(token_ll * mask).sum() / mask.sum().clamp_min(1.0)
    return -token_ll.mean()


def _chunked_ce_loss(cfg: TransformerConfig, params, h, aux, chunk: int, tp=None):
    """Sequence-chunked CE over final hidden ``h`` [B, S, H]: each chunk's
    [B, chunk, V] logits are recomputed in the backward
    (``torch.utils.checkpoint``), so at most one chunk's logits is alive.
    The same masked-mean semantics as :func:`_ce_loss`; under ``tp`` each
    chunk's logits are this rank's vocabulary slice and the recompute runs
    the chunk's all-reduces again."""
    from torch.utils.checkpoint import checkpoint

    if "labels" in aux:
        h_eff, labels = h, aux["labels"]
    else:
        h_eff, labels = h[:, :-1], aux["shift_ids"][..., 1:]
    B, Sp, H = h_eff.shape
    mask = aux.get("loss_mask")
    mask = torch.ones((B, Sp), dtype=torch.float32, device=h.device) if mask is None else \
        mask[..., :Sp].float()
    labels = labels.long()

    def chunk_ll(h_c, l_c, m_c):
        return (_token_ll(_unembed(cfg, params, h_c, tp), l_c, tp) * m_c).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, Sp, chunk):
        sl = slice(s0, s0 + chunk)
        total = total + checkpoint(chunk_ll, h_eff[:, sl], labels[:, sl], mask[:, sl],
                                   use_reentrant=False)
    return -total / mask.sum().clamp_min(1.0)


def loss_terms(cfg: TransformerConfig, params, batch, generator=None, tp=None):
    """The two terms of :func:`loss_fn`: (next-token cross entropy,
    ``moe_aux_loss_coef`` times the MoE aux loss, 0 for a dense model).
    Data parallelism weights them apart: the CE is a masked mean over the
    global microbatch, the aux term a mean over its rows."""
    input_ids = batch["input_ids"] if isinstance(batch, dict) else batch
    aux = _ce_aux(batch, input_ids)
    if cfg.loss_chunk and input_ids.shape[1] > cfg.loss_chunk:
        h, moe_aux = forward_hidden(cfg, params, input_ids, generator, tp)
        ce = _chunked_ce_loss(cfg, params, h, aux, int(cfg.loss_chunk), tp)
    else:
        logits, moe_aux = forward_with_aux(cfg, params, input_ids, generator, tp)
        ce = _ce_loss(logits, aux, tp)
    if cfg.moe_num_experts > 0:
        return ce, cfg.moe_aux_loss_coef * moe_aux
    return ce, torch.zeros((), device=ce.device)


def loss_fn(cfg: TransformerConfig, params, batch, generator=None, tp=None):
    """Next-token cross entropy, plus ``moe_aux_loss_coef`` times the MoE
    aux loss (``transformer.py:1025-1040``). ``batch``: a dict with
    'input_ids' [B, S] and optional 'labels' and 'loss_mask', or the ids
    tensor itself. ``cfg.loss_chunk`` routes through the sequence-chunked
    CE. ``generator``: the gating's randomness (None: no draws; see
    :func:`_moe_mlp`). ``tp``: ``params`` are this rank's shards; the loss
    is the whole model's, equal on every model rank."""
    ce, aux = loss_terms(cfg, params, batch, generator, tp)
    return ce + aux if cfg.moe_num_experts > 0 else ce


def tensor_parallel_dims(cfg: TransformerConfig, tp: TensorParallel) -> Dict[Tuple[str, str],
                                                                            Optional[int]]:
    """{(group, name): the dim ``tp`` splits of that per-layer leaf, or
    None}, from the config's whole shapes (built on the meta device)."""
    full = init_params(cfg, None, "meta", torch.float32, per_layer=True)
    dims = {}
    for group, leaves in full.items():
        for name, t in (leaves[0] if group == "blocks" else leaves).items():
            dims[(group, name)] = tp.split_dim(group, name, t.shape)
    return dims


def _rank_zero_params(cfg: TransformerConfig, tp: TensorParallel, seed: int, device, dtype,
                      per_layer: bool) -> Dict[str, Any]:
    """This rank's shards of the tree that world rank 0 draws from ``seed``
    (the tree a single rank would build): each leaf broadcast from world
    rank 0 as soon as it is drawn, and sliced; no other rank draws."""
    gen = torch.Generator(device=device).manual_seed(seed) if comm.get_rank() == 0 else None

    def place(group, name, t, stacked):
        comm.broadcast(t, src=0)
        return tp.shard(group, name, t, stacked)

    return init_params(cfg, gen, device, dtype, per_layer=per_layer, place=place)


class TransformerLM(nn.Module):
    """Holds a config and its parameter tree. ``params`` defaults to
    :func:`init_params` from ``torch.Generator(device).manual_seed(seed)``.

    Serving (the default): nested ``nn.ParameterDict``s in the stacked
    layout, no gradients. ``trainable=True``: fp32 masters with
    ``requires_grad``, ``blocks`` an ``nn.ModuleList`` of per-layer
    ``nn.ParameterDict``s (``params`` must then be in the per-layer layout,
    see ``convert.params_from_jax(per_layer=True)``); :meth:`loss` is the
    training objective the engine differentiates.

    ``tp`` (a :class:`TensorParallel`, e.g. :func:`tensor_parallel` of the
    config over the mesh's model group): the model holds this rank's shards
    (``params``, if given, are them: ``convert.tensor_parallel_shards``;
    else this rank's slices of the tree world rank 0 draws from ``seed``,
    broadcast and sliced leaf by leaf), each split parameter marked
    ``tensor_model_parallel`` with its ``partition_dim``, and every forward
    runs the tensor-parallel path. A model built whole becomes a rank's
    shards through :meth:`shard_tensor_parallel` (the engines call it)."""

    def __init__(self, config: TransformerConfig, params: Optional[Dict[str, Any]] = None, *,
                 device=None, seed: int = 0, dtype=None, trainable: bool = False,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        _refuse_unported(config)
        self.config = config
        self.trainable = trainable
        self.tp = None
        if params is None:
            dev = resolve_device(device)
            dtype = torch.float32 if trainable else dtype
            if tp is None:
                gen = torch.Generator(device=dev).manual_seed(seed)
                params = init_params(config, gen, dev, dtype, per_layer=trainable)
            else:
                params = _rank_zero_params(config, tp, seed, dev, dtype, trainable)
        if trainable:
            if not isinstance(params["blocks"], (list, tuple)):
                raise ValueError("a trainable TransformerLM takes per-layer blocks "
                                 "(convert.params_from_jax(..., per_layer=True))")
            for group, leaves in params.items():
                for t in (leaves.values() if group != "blocks" else
                          [t for layer in leaves for t in layer.values()]):
                    if t.dtype != torch.float32:
                        raise ValueError("a trainable TransformerLM holds fp32 masters")

        def pdict(leaves):
            return nn.ParameterDict({name: nn.Parameter(t, requires_grad=trainable)
                                     for name, t in leaves.items()})

        self.tree = nn.ModuleDict({
            group: (nn.ModuleList([pdict(layer) for layer in leaves]) if group == "blocks"
                    and trainable else pdict(leaves))
            for group, leaves in params.items()
        })
        if trainable:  # the experts, marked as upstream DeepSpeed marks them
            for layer in (self.tree["blocks"] if config.moe_num_experts > 0 else ()):
                for name in ("moe_wi", "moe_wg", "moe_wo"):
                    if name in layer:
                        layer[name].allreduce = False
        if tp is not None:
            self._mark_tensor_parallel(tp)

    def _leaves(self):
        """(group, name, parameter, whether it is stacked ``[L, ...]``) of
        every leaf, in the tree's order."""
        for group, mod in self.tree.items():
            if isinstance(mod, nn.ModuleList):
                for layer in mod:
                    for name, p in layer.items():
                        yield group, name, p, False
            else:
                for name, p in mod.items():
                    yield group, name, p, group == "blocks"

    def _mark_tensor_parallel(self, tp: TensorParallel) -> None:
        """Megatron's marks on the split parameters (``tensor_model_parallel``,
        ``partition_dim``: read by the ZeRO partition's norm and the engine's
        whole state dict); ``self.tp = tp``."""
        dims = tensor_parallel_dims(self.config, tp)
        for group, name, p, stacked in self._leaves():
            d = dims[(group, name)]
            p.tensor_model_parallel = d is not None
            p.partition_dim = None if d is None else d + int(stacked)
        self.tp = tp

    def shard_tensor_parallel(self, tp: TensorParallel) -> None:
        """A whole model -> this rank's shards, in place (the parameters stay
        the same objects): leaf by leaf, world rank 0's value broadcast and
        this rank's slice kept, so every rank starts from rank 0's weights.
        A model that holds shards of the same plan is left as it is."""
        if self.tp is not None:
            if (self.tp.size, self.tp.rank, self.tp.attn, self.tp.mlp, self.tp.vocab) != (
                    tp.size, tp.rank, tp.attn, tp.mlp, tp.vocab):
                raise ValueError(f"the model holds the shards of {self.tp}, not of {tp}")
            self.tp = tp
            return
        with torch.no_grad():
            for group, name, p, stacked in self._leaves():
                whole = comm.broadcast(p.data, src=0)
                p.data = tp.shard(group, name, whole, stacked)
        self._mark_tensor_parallel(tp)

    def params(self) -> Dict[str, Any]:
        """The parameter tree as plain nested dicts of tensors (no copies):
        the serving model's detached data; the trainable model's parameters
        themselves (so autograd reaches them), blocks as a per-layer list."""
        def leaves(d):
            return {name: (p if self.trainable else p.data) for name, p in d.items()}

        return {group: ([leaves(layer) for layer in mod] if isinstance(mod, nn.ModuleList)
                        else leaves(mod)) for group, mod in self.tree.items()}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.tree.parameters())

    def loss(self, batch, generator=None, params=None):
        """The training objective on ``params`` (default :meth:`params`; the
        ZeRO engine passes :meth:`gathered_params` at stage 3 and for
        expert-parallel experts)."""
        return loss_fn(self.config, self.params() if params is None else params, batch, generator,
                       self.tp)

    def _loss_terms(self, batch, generator=None, params=None):
        """:meth:`loss`'s (CE, aux) terms (:func:`loss_terms`), which the
        data-parallel engine weights apart."""
        return loss_terms(self.config, self.params() if params is None else params, batch,
                          generator, self.tp)

    def loss_count(self, batch) -> torch.Tensor:
        """The count the loss's mean divides by (:func:`ce_count`): the
        data-parallel engine weights each rank's loss by it."""
        return ce_count(batch)

    def zero_groups(self):
        """ZeRO's partition groups (``runtime/zero/partition.py``): the
        embeddings (the backward's last gradients), the final norm and head
        (its first), then one per block; each leaf as (key, parameter,
        whether the forward casts it to ``cfg.dtype``). Apart, the two ends'
        gradients complete at the two ends of the backward, so ZeRO-2 holds
        neither group's full gradient through the whole backward. A block's
        experts (``moe_wi``, ``moe_wg``, ``moe_wo``) carry the expert mark
        (``allreduce = False``): where the world divides E, the partition
        takes them out of the block's flat group, each rank owning its
        ``E / world`` experts (the reference's ``P(PIPE, DATA, ...)``)."""
        def leaves(groups):
            return [((group, name), p, takes_compute_dtype(group, name))
                    for group, mod in self.tree.items() if group in groups
                    for name, p in mod.items()]

        ends = [("embed", leaves(("embed", "pos_embed", "embed_norm"))),
                ("head", leaves(("final_norm", "lm_head")))]
        return ends + [(f"block{l}", [(("blocks", l, name), p, takes_compute_dtype("blocks", name))
                                      for name, p in layer.items()])
                       for l, layer in enumerate(self.tree["blocks"])]

    @property
    def gathers_experts(self) -> bool:
        """Whether the forward multiplies by every expert (the grouped
        path), so that expert-parallel experts are gathered for it."""
        return self.config.moe_num_experts > 0 and self.config.moe_impl == "grouped"

    def gathered_params(self, gather):
        """The parameter tree of a ZeRO forward: ``gather(i, whole_experts)``
        returns group i of :meth:`zero_groups` as {key: tensor}, the
        expert-parallel experts whole (gathered, for the grouped path) or as
        this rank's (the einsum path exchanges the slots). The two end
        groups are gathered now, each block when the layer loop reaches
        it."""
        whole = self.gathers_experts
        tree = {}
        for i in (0, 1):
            for (group, name), t in gather(i).items():
                tree.setdefault(group, {})[name] = t
        tree["blocks"] = GatheredLayers(
            len(self.tree["blocks"]),
            lambda l: {key[2]: t for key, t in gather(l + 2, whole_experts=whole).items()})
        return tree

    def forward(self, input_ids):
        return forward(self.config, self.params(), input_ids, self.tp)
