"""Tensor-parallel layers: Megatron's regions and the reference's layer
functions.

Counterpart of ``deepspeed_tpu/module_inject/layers.py`` (the reference's
``LinearAllreduce``, ``LinearLayer``, ``EmbeddingLayer``, ``Normalize``,
``RMSNormalize``). The JAX package writes them as plain functions whose
collectives XLA inserts from the sharding (or a ``psum`` inside
``shard_map``). PyTorch inserts nothing, so the collectives are explicit
``torch.autograd.Function`` regions over the model group
(``parallel.groups.get_model_parallel_group``), as Megatron-LM writes them:

- :func:`copy_to_model_parallel_region`: the forward is the identity, the
  backward sums the gradient over the model group. A column-parallel weight
  reads its input through it: each rank's gradient of that input is the
  part that flows through its own columns.
- :func:`reduce_from_model_parallel_region`: the forward sums the partial
  products of a row-parallel weight over the model group, the backward is
  the identity.
- :func:`gather_from_model_parallel_region`: every rank's last-dim slice
  concatenated (vocab-split logits for a caller that asks for them); the
  backward keeps this rank's slice.
- :func:`vocab_parallel_log_likelihood`: the log-likelihood of each label
  under logits split over the vocabulary, without any rank holding the
  whole row: the max over the model group, then the sum of exponentials,
  then the label's logit from the rank that owns it. Its backward is the
  softmax minus the one-hot on the rank's slice.

The layer functions take ``group`` (default: the mesh's model group). Where
the group has one rank (or there is none) they issue no collective, as the
reference's run outside ``shard_map``.
"""

import torch

from .. import comm
from ..comm.functional import all_gather, inference_all_reduce


def model_group(group=None):
    """``group``, else the current mesh's model group (None without one)."""
    if group is None:
        from ..parallel import groups

        group = groups.get_model_parallel_group()
    return group


def model_parallel_size(group) -> int:
    return comm.get_world_size(group) if group is not None else 1


class _CopyToModelRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        # a copy: autograd may hand the same gradient to another consumer
        grad = grad.clone(memory_format=torch.contiguous_format)
        return inference_all_reduce(grad, group=ctx.group), None


class _ReduceFromModelRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return inference_all_reduce(x.clone(memory_format=torch.contiguous_format), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModelRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        start = comm.get_rank(ctx.group) * ctx.n
        return grad.narrow(-1, start, ctx.n), None


def copy_to_model_parallel_region(x, group):
    return _CopyToModelRegion.apply(x, group)


def reduce_from_model_parallel_region(x, group):
    return _ReduceFromModelRegion.apply(x, group)


def gather_from_model_parallel_region(x, group):
    return _GatherFromModelRegion.apply(x, group)


class _VocabParallelLogLikelihood(torch.autograd.Function):
    """logits [..., V / tp] (fp32, this rank's vocabulary slice), labels
    [...] (global ids) -> log p(label) [...], equal on every rank."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        n = logits.shape[-1]
        local = labels.long() - comm.get_rank(group) * n
        inside = (local >= 0) & (local < n)
        idx = torch.where(inside, local, torch.zeros_like(local))
        m = inference_all_reduce(logits.max(dim=-1).values, op=comm.ReduceOp.MAX, group=group)
        shifted = logits - m[..., None]
        probs = shifted.exp()
        sumexp = inference_all_reduce(probs.sum(dim=-1), group=group)
        picked = shifted.gather(-1, idx[..., None])[..., 0]
        picked = inference_all_reduce(torch.where(inside, picked, torch.zeros_like(picked)),
                                      group=group)
        probs.div_(sumexp[..., None])
        ctx.save_for_backward(probs, idx, inside)
        return picked - sumexp.log()

    @staticmethod
    def backward(ctx, grad):
        probs, idx, inside = ctx.saved_tensors
        out = probs * (-grad[..., None])
        out.scatter_add_(-1, idx[..., None],
                         torch.where(inside, grad, torch.zeros_like(grad))[..., None])
        return out, None, None


def vocab_parallel_log_likelihood(logits, labels, group):
    """log softmax(logits)[label] over a vocabulary split across ``group``
    (this rank holds ``logits[..., r * n:(r + 1) * n]`` of the whole row);
    the plain ``log_softmax`` and gather at one rank."""
    if model_parallel_size(group) == 1:
        return torch.gather(torch.log_softmax(logits, dim=-1), -1,
                            labels[..., None].long())[..., 0]
    return _VocabParallelLogLikelihood.apply(logits, labels, group)


# ---------------------------------------------------------------------------
# the reference's layer functions
# ---------------------------------------------------------------------------

def linear_layer(x, weight, bias=None, group=None):
    """Column-parallel linear (reference ``LinearLayer:62``): this rank's
    output columns, no collective in the forward; the input enters the
    model region, so its gradient sums over the model group."""
    group = model_group(group)
    if model_parallel_size(group) > 1:
        x = copy_to_model_parallel_region(x, group)
    out = x @ weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def linear_allreduce(x, weight, bias=None, group=None):
    """Row-parallel linear (reference ``LinearAllreduce:16``): this rank's
    rows of the contraction, the partial products summed over the model
    group, the bias added once, after the sum."""
    group = model_group(group)
    out = x @ weight.to(x.dtype)
    if model_parallel_size(group) > 1:
        out = reduce_from_model_parallel_region(out, group)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def lm_head_linear_allreduce(x, weight, bias=None, group=None):
    """Reference ``LmHeadLinearAllreduce:33``: the row-parallel contract on
    the unembedding."""
    return linear_allreduce(x, weight, bias, group=group)


def embedding_layer(ids, weight, group=None):
    """Reference ``EmbeddingLayer:104``, vocab-parallel: ``weight`` holds
    this rank's rows ``[r * n, (r + 1) * n)`` of the table; an id outside
    them gives a zero row, and the rows are summed over the model group."""
    group = model_group(group)
    if model_parallel_size(group) == 1:
        return weight[ids]
    n = weight.shape[0]
    local = ids.long() - comm.get_rank(group) * n
    inside = (local >= 0) & (local < n)
    rows = weight[torch.where(inside, local, torch.zeros_like(local))]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model_parallel_region(rows, group)


def opt_embedding(positions, weight, offset: int = 2):
    """Reference ``OPTEmbedding:121``: OPT's learned positions start at a
    +2 offset."""
    return weight[positions + offset]


def normalize(x, scale, bias=None, eps: float = 1e-5):
    """LayerNorm in fp32 (reference ``Normalize:86``), cast back to x's
    dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).pow(2).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_normalize(x, scale, eps: float = 1e-5):
    """RMSNorm in fp32 (reference ``RMSNormalize:145``), cast back to x's
    dtype."""
    x32 = x.float()
    out = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)
