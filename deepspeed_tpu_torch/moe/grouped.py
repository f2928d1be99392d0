"""Grouped-matmul MoE dispatch: expert-sorted tokens through the grouped
matmul kernels (``ops/grouped_matmul.py``).

Counterpart of ``deepspeed_tpu/moe/grouped.py``. The FFN work scales with
the routed tokens (plus at most one zero row block per expert), not with
the one-hot dispatch's ``S * E * C``. The kept assignments and their gate
weights come from the per-token combine weights ``w_se`` (the capacity
gate's combine summed over slots), so the result equals the einsum path's.

Every shape is static and every step is a device op: top-k, a stable sort
by expert, per-expert counts (a scatter-add, not ``bincount``, which reads
its maximum back to the host on CUDA), block-aligned group starts and the
row block -> expert table by ``searchsorted``. ``T_pad = round_up(S * k,
bt) + E * bt`` is a Python int; no count is read back.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _round_up(x, m):
    return (x + m - 1) // m * m


def top_k_lowest_index(x, k: int):
    """``jax.lax.top_k`` over the last dim: among equal values the lower
    index comes first (a stable descending sort; ``torch.topk`` does not
    promise an order among ties). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def block_align_dispatch(w_se, top_k: int, block_rows: int, top_idx=None, top_w=None,
                         num_experts: Optional[int] = None):
    """From per-token combine weights [S, E], or precomputed routing
    ``top_idx``/``top_w`` [S, k] with ``num_experts``: slot order,
    destinations and the row block -> expert table. Returns (flat_tok
    [S*k], flat_w [S*k], dest [S*k], block_expert [T_pad // block_rows]
    int32, T_pad)."""
    if top_idx is not None:
        if num_experts is None:
            raise ValueError("num_experts is required with precomputed top_idx")
        S, E = top_idx.shape[0], num_experts
        wvals, idx = top_w, top_idx
    else:
        S, E = w_se.shape
        wvals, idx = top_k_lowest_index(w_se, top_k)
    dev = idx.device
    flat_e = idx.reshape(-1).long()
    flat_w = wvals.reshape(-1)
    flat_tok = torch.arange(S * top_k, device=dev) // top_k
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sizes = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(0, flat_e,
                                                                      torch.ones_like(flat_e))
    # block-aligned groups, at least one block each (tgmm visits every
    # expert's output; zero rows contribute zero gradient)
    padded = torch.clamp(_round_up(sizes, block_rows), min=block_rows)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    starts = torch.cat([zero, torch.cumsum(padded, 0)])[:E]
    un_starts = torch.cat([zero, torch.cumsum(sizes, 0)])[:E]
    rank = torch.arange(S * top_k, device=dev) - un_starts[sorted_e]  # position in its group
    dest = starts[sorted_e] + rank  # row in the padded buffer
    T_pad = _round_up(S * top_k, block_rows) + E * block_rows  # static bound
    rows = torch.arange(T_pad // block_rows, device=dev) * block_rows
    block_expert = (torch.searchsorted(starts, rows, right=True) - 1).to(torch.int32)
    return flat_tok[order], flat_w[order], dest, block_expert, T_pad


def _default_activation(up, gate):
    if gate is not None:
        return F.silu(gate) * up
    return F.gelu(up, approximate="tanh")


def grouped_moe_ffn(x, w_se, wi, wo, top_k: int, wg=None, activation: Optional[Callable] = None,
                    block_rows: Optional[int] = None, top_idx=None, top_w=None):
    """x [S, M] tokens; w_se [S, E] combine weights (nonzero = a kept
    assignment), or precomputed routing ``top_idx``/``top_w`` [S, k]; wi
    [E, M, F]; wg: optional SwiGLU gate weights [E, M, F]; wo [E, F, M].
    ``activation(up, gate)`` (gate None without wg); default silu(gate)*up
    or gelu(up). ``block_rows`` defaults to 128 on CUDA (the kernels' row
    tile) and 8 elsewhere (the TPU package's CPU choice).

    Returns y [S, M] = sum over kept assignments of w * FFN_e(x)."""
    if block_rows is None:
        block_rows = 128 if x.is_cuda else 8
    activation = activation or _default_activation
    S, M = x.shape
    from ..ops.grouped_matmul import grouped_matmul

    tok, w_slot, dest, block_expert, T_pad = block_align_dispatch(
        w_se, top_k, block_rows, top_idx=top_idx, top_w=top_w, num_experts=wi.shape[0])
    x_sorted = x.new_zeros((T_pad, M)).index_copy(0, dest, x[tok])

    def gm(a, w):
        return grouped_matmul(a, w.to(x.dtype), block_expert, block_rows)

    up = gm(x_sorted, wi)
    gate = gm(x_sorted, wg) if wg is not None else None
    y_sorted = gm(activation(up, gate), wo)
    y_slots = y_sorted[dest] * w_slot[:, None].to(x.dtype)
    return x.new_zeros((S, M)).index_add(0, tok, y_slots)
