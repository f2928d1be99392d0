"""DS4Science Evoformer attention (triangle / MSA attention with bias terms).

Counterpart of ``deepspeed_tpu/ops/evoformer_attn.py``: the DeepSpeed
public op ``DS4Sci_EvoformerAttention``. Q/K/V are ``[*, n_seq, n_res,
heads, dim]`` and up to two bias terms broadcast to the score tensor
``[*, n_seq, heads, n_res, n_res]``: the MSA mask bias and the pair bias of
AlphaFold's Evoformer block.

On a CUDA tensor the AlphaFold bias pattern (:func:`_route`) goes to the
hand-written CUDA kernels of ``ops/evoformer_attention.py`` (forward and
backward with both bias gradients, never the ``[n_res, n_res]``
probabilities in device memory). CPU tensors, and every other layout, take
the chunked plain path and honour ``seq_chunk``, as the JAX package does
off the TPU without ``interpret``. The kernels' ``autograd.Function`` over
their plain versions stays reachable on the CPU through ``evo_flash``.

The route's shape guard is the CUDA kernels' own: head_dim in
``HEAD_DIMS`` (32, 64, 128), bf16 / fp16 / fp32 q/k/v, any n_res (ragged
tiles are masked inside the kernels). The TPU's lane rule (``n_res % 128
== 0``, ``dim >= 32``) comes from its (8, 128) tiling and does not apply.
"""

import math
from functools import partial
from typing import Optional, Sequence

import torch

from .evoformer_attention import DTYPES, HEAD_DIMS, evo_flash


def _route(q, biases):
    """(bias1 [.., n_seq, 1, 1, R], bias2 [.., 1, h, R, R]) when the
    kernels take this call (either may be None), else None: the first bias
    shaped ``(n_seq, 1, 1, R)`` is the mask bias, the first shaped ``(1, h,
    R, R)`` the pair bias, and any other layout goes to the chunked path."""
    *lead, n_seq, R, h, d = q.shape
    if d not in HEAD_DIMS or q.dtype not in DTYPES:
        return None
    b1 = b2 = None
    for b in biases:
        if b is None:
            continue
        if tuple(b.shape[-4:]) == (n_seq, 1, 1, R) and b1 is None:
            b1 = b
        elif tuple(b.shape[-4:]) == (1, h, R, R) and b2 is None:
            b2 = b
        else:
            return None  # a bias layout the kernels don't cover
    return b1, b2


def _evoformer_kernel(q, k, v, b1, b2):
    """Collapse the leading dims and run the fused kernels. The biases are
    broadcast to ``[*lead, n_seq, 1, 1, R]`` / ``[*lead, 1, h, R, R]`` and
    taken in fp32, so their gradients flow back to their own shapes and
    dtypes."""
    *lead, n_seq, R, h, d = q.shape
    G = 1
    for x in lead:
        G *= x
    N = G * n_seq
    b1f = (torch.broadcast_to(b1, (*lead, n_seq, 1, 1, R)).reshape(N, R).float()
           if b1 is not None else None)
    b2f = (torch.broadcast_to(b2, (*lead, 1, h, R, R)).reshape(G, h, R, R).float()
           if b2 is not None else None)
    out = evo_flash(q.reshape(N, R, h, d), k.reshape(N, R, h, d), v.reshape(N, R, h, d), b1f,
                    b2f)
    return out.reshape(*lead, n_seq, R, h, d)


def _attend(q, k, v, biases):
    """Plain attention in fp32: q [..., c, n_res, h, d] -> scores
    [..., c, h, n_res, n_res] plus the biases, softmax, then p . v."""
    s = torch.einsum("...qhd,...khd->...hqk", q.float() * (1.0 / math.sqrt(q.shape[-1])),
                     k.float())
    for b in biases:
        if b is not None:
            s = s + b.float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", p, v.float()).to(q.dtype)


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Sequence[Optional[torch.Tensor]] = (),
                        seq_chunk: int = 0) -> torch.Tensor:
    """Fused biased attention.

    q/k/v: [..., n_seq, n_res, heads, dim] (the reference layout).
    biases: up to two tensors broadcastable to [..., n_seq, heads, n_res,
    n_res] (e.g. mask bias [.., n_seq, 1, 1, n_res] and pair bias
    [.., 1, heads, n_res, n_res]).
    seq_chunk: process the n_seq dim in chunks of this size to bound the
    live score tensor on the plain path (0 = no chunking; ignored on the
    kernel route, whose residency is already tile-bounded).
    Returns [..., n_seq, n_res, heads, dim].
    """
    routed = _route(q, biases) if q.is_cuda else None
    if routed is not None:
        return _evoformer_kernel(q, k, v, routed[0], routed[1])
    if not seq_chunk or q.shape[-4] <= seq_chunk:
        return _attend(q, k, v, list(biases))

    n_seq = q.shape[-4]
    if n_seq % seq_chunk:
        raise ValueError(f"n_seq {n_seq} must divide by seq_chunk {seq_chunk}")
    chunks = []
    for i in range(n_seq // seq_chunk):
        sl = lambda x: x.narrow(-4, i * seq_chunk, seq_chunk)  # noqa: E731
        bias_c = [b if b is None or b.shape[-4] == 1 else sl(b) for b in biases]
        chunks.append(_attend(sl(q), sl(k), sl(v), bias_c))
    return torch.cat(chunks, dim=-4)


DS4Sci_EvoformerAttention = partial(evoformer_attention)  # reference public name
