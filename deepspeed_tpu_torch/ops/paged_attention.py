"""Paged (blocked) attention over a flat KV pool: the serving data plane's
attention, for PyTorch on an NVIDIA H100.

Counterpart of ``deepspeed_tpu/ops/pallas/paged_attention.py``. Query token
``t`` belongs to sequence ``seq_idx[t]`` at absolute position ``pos[t]`` and
attends every cached position ``<= pos[t]`` of that sequence (and, with a
``window``, only those in ``(pos[t] - window, pos[t]]``); the sequence's KV
lives in the pool blocks its block-table row lists. Prefill chunks and
decode steps of many sequences mix in one call.

- :func:`paged_attention_reference` is the plain PyTorch version (a gather
  of each sequence's context): the CPU path and the numerics oracle.
- :func:`paged_decode` and :func:`paged_prefill` wrap the hand-written CUDA
  kernels of ``csrc/paged_attention.cu``. On a CPU tensor they return the
  plain version; on a CUDA tensor they launch their kernel or raise.
- :func:`paged_attention` dispatches between them with the shape heuristics
  of the TPU package (no kernel-config registry, no environment overrides).

The split decode (``kv_splits > 1``) splits each token's live blocks, not
the table's capacity (:func:`decode_split_plan`), into fp32 partials that a
second CUDA kernel merges, both launched by one C call.
:func:`paged_decode_partials_reference` and :func:`merge_decode_splits` are
the plain versions of the two halves; :func:`paged_decode_partials` and
:func:`paged_decode_merge` launch each kernel alone (checks and timings).

``launch_counts`` counts kernel launches per path; nothing else adds to it.
"""

import ctypes
import math

import torch

from ._build import build_kernel

MASK_VALUE = -1e30
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 256)  # the head dims the kernels are built for
DECODE_HEAD_TILE = 8  # query heads a decode CTA takes (the mma's n side)
PREFILL_ROWS = 64  # query rows (tokens x heads of a kv head) a prefill CTA takes


def unsupported_shape(nq: int, nkv: int, d: int) -> list:
    """What of (query heads, kv heads, head dim) the kernels are not built
    for, one message a miss; empty if they take it. Any group size takes
    the kernels: the decode's head tiles and the prefill's row chunks
    cover it (:func:`decode_head_tiles`, :func:`prefill_row_chunks`)."""
    misses = []
    if d not in KERNEL_HEAD_DIMS:
        misses.append(f"head_dim {d} (the kernels are built for {KERNEL_HEAD_DIMS})")
    if nkv < 1 or nq % nkv:
        misses.append(f"{nq} query heads over {nkv} kv heads (not a multiple)")
    return misses

# launches of each kernel path since the last reset_launch_counts()
# (the split decode's call launches the split kernel and the merge: one each)
launch_counts = {"paged_decode": 0, "paged_decode_split": 0, "paged_decode_merge": 0,
                 "paged_prefill": 0}

_built = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_build():
    """Build (first call) and return the kernel library: ``.lib`` is the
    loaded handle, ``.seconds`` nvcc's wall time, ``.ptxas`` its report."""
    global _built
    if _built is None:
        built = build_kernel("paged_attention")
        lib = built.lib
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ds_paged_decode.argtypes = [vp] * 5 + [ll] + [vp] * 8 + [i] * 9 + [vp]
        lib.ds_paged_decode.restype = i
        lib.ds_paged_decode_merge.argtypes = [vp] * 4 + [ll, i, i, vp]
        lib.ds_paged_decode_merge.restype = i
        lib.ds_paged_prefill.argtypes = [vp] * 5 + [ll] + [vp] * 9 + [i] * 10 + [vp]
        lib.ds_paged_prefill.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        lib.ds_paged_smem_bytes.argtypes = [i, i]
        lib.ds_paged_smem_bytes.restype = ll
        lib.ds_paged_prefill_smem_bytes.argtypes = [i, i]
        lib.ds_paged_prefill_smem_bytes.restype = ll
        _built = built
    return _built


# ---------------------------------------------------------------------------
# dispatch heuristics (deepspeed_tpu/ops/pallas/paged_attention.py:43-125,
# defaults only)
# ---------------------------------------------------------------------------

def resolve_q_tile(T: int, S: int) -> int:
    """Tile only batches with real multi-token chunks: a pure-decode batch
    has one token per sequence, where a tile buys no KV amortisation. Here
    only the route (prefill when > 1, decode otherwise): the prefill kernel
    sizes its own tile (:func:`prefill_q_tile`)."""
    return 8 if (T >= 64 and T >= 2 * max(S, 1)) else 1


def prefill_q_tile(g: int) -> int:
    """The prefill kernel's default tile for ``g`` query heads per kv head:
    ``64 // g`` tokens for g <= 64, so a CTA's rows (tokens x heads) fill
    its 64 (four warps of 16 on the tensor cores); 8 tokens above, whose
    ``8 g`` rows run as :func:`prefill_row_chunks` CTAs of 64, every one but
    the last full and the last's padding under a ninth of the rows."""
    return PREFILL_ROWS // g if g <= PREFILL_ROWS else 8


def prefill_row_chunks(g: int, q_tile: int) -> int:
    """CTAs a prefill tile of ``q_tile`` tokens takes for ``g`` query heads
    per kv head: its ``q_tile g`` rows in chunks of 64 (the grid's third
    dimension); one at the default tile for g <= 64."""
    return -(-q_tile * g // PREFILL_ROWS)


def decode_head_tiles(g: int) -> int:
    """CTAs the decode takes per (token, kv head, split) for ``g`` query
    heads per kv head: tiles of up to 8 heads, the last holding the rest
    (one for g <= 8; nine at Falcon-7B's 71, the last of 7)."""
    return -(-g // DECODE_HEAD_TILE)


def resolve_kv_splits(T: int, S: int, max_blocks: int, q_tile: int = 1) -> int:
    """Split-K only decode-shaped batches (per-token grid, T <= 2S) whose
    tables hold at least 8 blocks."""
    if q_tile > 1 or max_blocks < 8 or T > 2 * max(S, 1):
        return 1
    return max(1, min(min(8, max(1, max_blocks // 4)), max_blocks))


def paged_attention(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size: int, window=None,
                    alibi=None, k_scale=None, v_scale=None):
    """q: [T, nq, d]; k_pool/v_pool: [pool_len, nkv, d] (may include a
    trailing scratch slot that no table references); block_tables:
    [S, max_blocks] int32; seq_idx/pos: [T] int32. ``k_scale``/``v_scale``
    [nkv, >= pool_len] fp32 select int8 pools. Same-sequence tokens must be
    contiguous (the ragged batch layout): a prefill-shaped batch takes the
    q-tiled kernel. Returns [T, nq, d] in q's dtype."""
    T = q.shape[0]
    S, max_blocks = block_tables.shape
    if resolve_q_tile(T, S) > 1:
        return paged_prefill(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size,
                             window=window, alibi=alibi, k_scale=k_scale, v_scale=v_scale)
    return paged_decode(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size, window=window,
                        alibi=alibi, k_scale=k_scale, v_scale=v_scale,
                        kv_splits=resolve_kv_splits(T, S, max_blocks))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _scores(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size, window, alibi, k_scale,
            v_scale):
    """The plain versions' fp32 scores over each token's whole table
    capacity, masked ones at -1e30 ([T, nkv, g, C]), and the gathered
    dequantised values ([T, C, nkv, d])."""
    T, nq, d = q.shape
    nkv = k_pool.shape[1]
    g = nq // nkv
    S, max_blocks = block_tables.shape
    C = max_blocks * block_size
    dev = q.device
    block_tables = block_tables.long()
    seq_idx = seq_idx.long()
    pos = pos.long()
    ctx_slots = (block_tables[:, :, None] * block_size
                 + torch.arange(block_size, device=dev)[None, None, :]).reshape(S, C)
    ctxk = k_pool[ctx_slots].float()  # [S, C, nkv, d]
    ctxv = v_pool[ctx_slots].float()
    if k_scale is not None:
        ctxk = ctxk * k_scale.t()[ctx_slots][..., None]
        ctxv = ctxv * v_scale.t()[ctx_slots][..., None]
    qr = (q.float() / math.sqrt(d)).reshape(T, nkv, g, d)
    s = torch.einsum("tngd,tcnd->tngc", qr, ctxk[seq_idx])
    cpos = torch.arange(C, device=dev)
    if alibi is not None:
        rel = cpos[None, :].float() - pos[:, None].float()
        slopes = torch.as_tensor(alibi, dtype=torch.float32, device=dev).reshape(nkv, g)
        s = s + slopes[None, :, :, None] * rel[:, None, None, :]
    vis = cpos[None, :] <= pos[:, None]
    if window is not None:
        vis = vis & (pos[:, None] - cpos[None, :] < int(window))
    s = torch.where(vis[:, None, None, :], s, torch.full_like(s, MASK_VALUE))
    return s, ctxv[seq_idx]


def paged_attention_reference(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size: int,
                              window=None, alibi=None, k_scale=None, v_scale=None):
    """Gather-based plain version of ``paged_attention`` (the TPU package's
    ``paged_attention_reference``, :202-244): fp32 scores, masked entries at
    -1e30, softmax over each sequence's whole table capacity."""
    T, nq, d = q.shape
    s, ctxv = _scores(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size, window, alibi,
                      k_scale, v_scale)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("tngc,tcnd->tngd", p, ctxv)
    return out.reshape(T, nq, d).to(q.dtype)


def decode_split_plan(pos, block_size: int, max_blocks: int, kv_splits: int, window=None):
    """Each split's share of each token's live blocks, as the decode kernel
    computes it: token ``t`` at position ``pos[t] >= 0`` has the live blocks
    ``[j_lo, j_hi]`` (``j_hi = min(pos // block_size, max_blocks - 1)``;
    ``j_lo`` the block of ``pos - window + 1`` with a window, else 0: the
    blocks the TPU kernels' block predicate keeps), and split ``s`` takes
    blocks ``[j_lo + s n // kv_splits, j_lo + (s + 1) n // kv_splits)`` of
    the ``n`` of them. A token at a negative position has none. Returns
    int64 ``(b0, b1)``, each ``[kv_splits, T]``; a split with ``b1 == b0``
    has no live block."""
    pos = pos.long()
    j_hi = torch.where(pos >= 0, torch.clamp(pos // block_size, max=max_blocks - 1),
                       torch.full_like(pos, -1))
    j_lo = torch.zeros_like(pos)
    if window is not None and int(window) > 0:
        x = pos - int(window) + 1
        j_lo = torch.where(x > 0, x // block_size, j_lo)
    n_live = torch.clamp(j_hi - j_lo + 1, min=0)
    s = torch.arange(kv_splits, device=pos.device)[:, None]
    return j_lo + s * n_live // kv_splits, j_lo + (s + 1) * n_live // kv_splits


def paged_decode_partials_reference(q, k_pool, v_pool, block_tables, seq_idx, pos,
                                    block_size: int, kv_splits: int, window=None, alibi=None,
                                    k_scale=None, v_scale=None):
    """Plain version of the split decode's partials: for each split of
    :func:`decode_split_plan`, the un-normalised ``acc = sum p v`` with
    ``p = exp(s - m)`` over the positions of the split's blocks (masked ones
    at score -1e30), their max score ``m`` (-1e30 for a split with no live
    block) and mass ``l = sum p``. Returns fp32 ``acc [kv_splits, T, nq,
    d]``, ``m`` and ``l [kv_splits, T, nq]``."""
    T, nq, d = q.shape
    max_blocks = block_tables.shape[1]
    C = max_blocks * block_size
    s, ctxv = _scores(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size, window, alibi,
                      k_scale, v_scale)  # [T, nkv, g, C], [T, C, nkv, d]
    b0, b1 = decode_split_plan(pos, block_size, max_blocks, kv_splits, window)
    cpos = torch.arange(C, device=q.device)
    inside = (cpos >= b0[..., None] * block_size) & (cpos < b1[..., None] * block_size)
    inside = inside[:, :, None, None, :]  # [splits, T, 1, 1, C]
    m = torch.where(inside, s[None], torch.full_like(s[None], -math.inf)).amax(dim=-1)
    m = m.clamp_min(MASK_VALUE)  # a split with no position: -1e30
    p = torch.where(inside, torch.exp(s[None] - m[..., None]), torch.zeros_like(s[None]))
    acc = torch.einsum("ktngc,tcnd->ktngd", p, ctxv)
    return (acc.reshape(kv_splits, T, nq, d), m.reshape(kv_splits, T, nq),
            p.sum(dim=-1).reshape(kv_splits, T, nq))


def merge_decode_splits(acc, m, l, dtype=torch.bfloat16):
    """Plain version of the splits' merge (the TPU kernel's :700-703):
    ``m* = max m``, ``w = exp(m - m*)``, ``out = sum w acc / max(sum w l,
    1e-30)``, over the leading split dimension; dead splits (m = -1e30,
    l = 0) weigh 0 beside a live one."""
    m_star = m.amax(dim=0, keepdim=True)
    w = torch.exp(m - m_star)
    num = (acc * w[..., None]).sum(dim=0)
    den = (l * w).sum(dim=0).clamp_min(1e-30)
    return (num / den[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# prefill tiles
# ---------------------------------------------------------------------------

def prefill_tiles(seq_idx, pos, q_tile: int, n_seqs: int):
    """Tile descriptors of the q-tiled prefill: each run of contiguous
    same-sequence tokens is cut into tiles of at most ``q_tile`` tokens, so a
    tile never crosses a sequence. Torch ops on ``seq_idx``'s device (no
    host sync). ``n_tiles`` is the static bound ceil(T/q_tile) + n_seqs + 1
    (the TPU kernel's): interior cuts, one ragged tail per run and the pad
    run. Returns int32 ``(tile_start, tile_len, tile_seq, tile_max,
    tile_min)`` of length n_tiles; unused tiles have length 0."""
    T = seq_idx.shape[0]
    dev = seq_idx.device
    n_tiles = -(-T // q_tile) + n_seqs + 1
    seq_idx = seq_idx.to(torch.int32)
    pos = pos.to(torch.int32)
    tok = torch.arange(T, dtype=torch.int64, device=dev)
    newrun = torch.ones(T, dtype=torch.bool, device=dev)
    newrun[1:] = seq_idx[1:] != seq_idx[:-1]
    run_start = torch.cummax(torch.where(newrun, tok, torch.zeros_like(tok)), dim=0).values
    within = tok - run_start
    tile_id = torch.cumsum((within % q_tile == 0).to(torch.int64), dim=0) - 1
    i32 = dict(dtype=torch.int32, device=dev)
    tile_len = torch.zeros(n_tiles, **i32).index_add_(0, tile_id, torch.ones(T, **i32))
    tile_start = torch.zeros(n_tiles, **i32).scatter_reduce_(
        0, tile_id, tok.to(torch.int32), reduce="amin", include_self=False)
    tile_seq = torch.zeros(n_tiles, **i32).scatter_reduce_(
        0, tile_id, seq_idx, reduce="amax", include_self=False)
    tile_max = torch.full((n_tiles, ), -1, **i32).scatter_reduce_(
        0, tile_id, pos, reduce="amax", include_self=True)
    tile_min = torch.full((n_tiles, ), 2**30, **i32).scatter_reduce_(
        0, tile_id, pos, reduce="amin", include_self=True)
    return tile_start, tile_len, tile_seq, tile_max, tile_min


# the last descriptors computed on a card, with the very tensors they came
# from: every layer of one serving forward passes the same seq_idx and pos,
# so the ~25 small torch launches of prefill_tiles run once per forward
_tiles_memo = None


def cached_prefill_tiles(seq_idx, pos, q_tile: int, n_seqs: int):
    """:func:`prefill_tiles`, reused while ``seq_idx`` and ``pos`` are the
    same tensor objects, unmodified (their in-place version counters
    unchanged), with the same ``q_tile`` and ``n_seqs``. The memo holds
    those tensors, so their memory cannot be reused by others while it
    stands."""
    global _tiles_memo
    key = (seq_idx._version, pos._version, int(q_tile), int(n_seqs))
    m = _tiles_memo
    if m is None or m[0] is not seq_idx or m[1] is not pos or m[2] != key:
        m = _tiles_memo = (seq_idx, pos, key, prefill_tiles(seq_idx, pos, q_tile, n_seqs))
    return m[3]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_common(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size, k_scale, v_scale,
                  alibi):
    if q.dtype != torch.bfloat16 or q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [T, nq, d] bfloat16 tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    T, nq, d = q.shape
    if k_pool.dim() != 3 or k_pool.shape != v_pool.shape or k_pool.shape[2] != d:
        raise ValueError(f"pools must be [pool_len, nkv, {d}], got {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)}")
    nkv = k_pool.shape[1]
    misses = unsupported_shape(nq, nkv, d)
    if misses:
        raise ValueError("the paged kernels do not take " + "; ".join(misses))
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"pools must both be bfloat16 or int8, got {k_pool.dtype}/{v_pool.dtype}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous")
    quant = k_pool.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need k_scale and v_scale; bfloat16 pools take none")
    if not 1 <= block_size <= 128:
        raise ValueError(f"block_size {block_size} unsupported (1..128)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("q", q)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (sc.dtype != torch.float32 or sc.dim() != 2 or sc.shape[0] != nkv
                    or sc.stride(1) != 1 or sc.shape[1] < k_pool.shape[0]
                    or sc.device != q.device):
                raise ValueError(f"{name} must be fp32 [nkv, >= pool_len] with unit lane "
                                 f"stride on q's device, got {sc.dtype} {tuple(sc.shape)}")
        if k_scale.stride(0) != v_scale.stride(0):
            raise ValueError("k_scale and v_scale must share one row stride")
    if block_tables.dim() != 2 or seq_idx.shape != (T, ) or pos.shape != (T, ):
        raise ValueError("block_tables must be [S, max_blocks], seq_idx and pos [T]")
    for name, t in (("block_tables", block_tables), ("seq_idx", seq_idx), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
    if alibi is not None:
        if not torch.is_tensor(alibi):
            alibi = torch.as_tensor(alibi, dtype=torch.float32)
        alibi = alibi.to(device=q.device, dtype=torch.float32).contiguous()
        if alibi.shape != (nq, ):
            raise ValueError(f"alibi slopes must be [nq={nq}], got {tuple(alibi.shape)}")
    return T, nq, d, nkv, quant, alibi


def _i32(t):
    return t.to(torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_if(rc: int, name: str) -> None:
    if rc:
        msg = kernel_build().lib.ds_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def _window(window) -> int:
    return 0 if window is None else int(window)


def _decode(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size, window, alibi, k_scale,
            v_scale, kv_splits, out, partials):
    """Check and launch ``ds_paged_decode``: ``out`` without partials
    (kv_splits 1), the partials alone without ``out``, or both (split then
    merge). Returns (out, partials)."""
    T, nq, d, nkv, quant, alibi = _check_common(q, k_pool, v_pool, block_tables, seq_idx, pos,
                                                block_size, k_scale, v_scale, alibi)
    max_blocks = block_tables.shape[1]
    tables, seq_idx, pos = _i32(block_tables), _i32(seq_idx), _i32(pos)
    lib = kernel_build().lib
    out = torch.empty_like(q) if out else None
    acc = m = l = None
    if partials:
        acc = torch.empty((kv_splits, T, nq, d), dtype=torch.float32, device=q.device)
        m = torch.empty((kv_splits, T, nq), dtype=torch.float32, device=q.device)
        l = torch.empty((kv_splits, T, nq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ds_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        k_scale.stride(0) if quant else 0, tables.data_ptr(), seq_idx.data_ptr(), pos.data_ptr(),
        _ptr(alibi), _ptr(out), _ptr(acc), _ptr(m), _ptr(l), T, nq, nkv, d, block_size,
        max_blocks, _window(window), kv_splits, int(quant), stream)
    _raise_if(rc, "paged_decode")
    return out, (acc, m, l)


def paged_decode(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size: int, window=None,
                 alibi=None, k_scale=None, v_scale=None, kv_splits: int = 1):
    """Per-token paged attention (one CTA per token, kv head and KV split).
    ``kv_splits > 1`` is the flash-decode split over each token's live
    blocks: fp32 partials per split, merged by a second kernel launched by
    the same C call (no torch op after the launch). CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables, seq_idx, pos,
                                         block_size, window=window, alibi=alibi,
                                         k_scale=k_scale, v_scale=v_scale)
    kv_splits = max(1, min(int(kv_splits), block_tables.shape[1]))
    out, _ = _decode(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size, window, alibi,
                     k_scale, v_scale, kv_splits, out=True, partials=kv_splits > 1)
    if kv_splits == 1:
        launch_counts["paged_decode"] += 1
    else:
        launch_counts["paged_decode_split"] += 1
        launch_counts["paged_decode_merge"] += 1
    return out


def paged_decode_partials(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size: int,
                          kv_splits: int, window=None, alibi=None, k_scale=None, v_scale=None):
    """The split decode kernel alone (no merge): ``(acc, m, l)`` as
    :func:`paged_decode_partials_reference` returns them, which CPU tensors
    take. For checks and timings; ``kv_splits`` is used as given (>= 1)."""
    if q.device.type == "cpu":
        return paged_decode_partials_reference(q, k_pool, v_pool, block_tables, seq_idx, pos,
                                               block_size, kv_splits, window=window, alibi=alibi,
                                               k_scale=k_scale, v_scale=v_scale)
    if int(kv_splits) < 1:
        raise ValueError(f"kv_splits must be >= 1, got {kv_splits}")
    _, parts = _decode(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size, window, alibi,
                       k_scale, v_scale, int(kv_splits), out=False, partials=True)
    launch_counts["paged_decode_split"] += 1
    return parts


def paged_decode_merge(acc, m, l, dtype=torch.bfloat16):
    """The merge kernel alone: the partials ``acc [splits, T, nq, d]``,
    ``m``, ``l [splits, T, nq]`` (fp32, contiguous) into ``[T, nq, d]``
    bf16. CPU tensors take :func:`merge_decode_splits`."""
    if acc.device.type == "cpu":
        return merge_decode_splits(acc, m, l, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the merge kernel writes bfloat16, not {dtype}")
    splits, T, nq, d = acc.shape
    for name, t, shape in (("acc", acc, (splits, T, nq, d)), ("m", m, (splits, T, nq)),
                           ("l", l, (splits, T, nq))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != acc.device):
            raise ValueError(f"{name} must be a contiguous fp32 {shape} tensor on acc's device, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported: the kernels are built for {KERNEL_HEAD_DIMS}")
    out = torch.empty((T, nq, d), dtype=dtype, device=acc.device)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = kernel_build().lib.ds_paged_decode_merge(acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                                                  out.data_ptr(), T * nq, d, splits, stream)
    _raise_if(rc, "paged_decode_merge")
    launch_counts["paged_decode_merge"] += 1
    return out


def paged_prefill(q, k_pool, v_pool, block_tables, seq_idx, pos, block_size: int, window=None,
                  alibi=None, k_scale=None, v_scale=None, q_tile=None):
    """Q-tiled paged attention: one CTA per (tile of up to ``q_tile``
    contiguous same-sequence tokens, kv head, chunk of 64 of the tile's
    ``q_tile g`` rows), so each KV slot is read once per chunk for all its
    rows' tokens and query heads. ``q_tile`` defaults to
    :func:`prefill_q_tile` (``64 // g``: 16 tokens at Mistral's g = 4, one
    chunk; 8 tokens in nine chunks at Falcon-7B's g = 71). Tiles never cross
    a sequence, so the result does not depend on the tile. Reads q and
    writes the output in token order. CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables, seq_idx, pos,
                                         block_size, window=window, alibi=alibi,
                                         k_scale=k_scale, v_scale=v_scale)
    T, nq, d, nkv, quant, alibi = _check_common(q, k_pool, v_pool, block_tables, seq_idx, pos,
                                                block_size, k_scale, v_scale, alibi)
    S, max_blocks = block_tables.shape
    q_tile = prefill_q_tile(nq // nkv) if q_tile is None else int(q_tile)
    if q_tile < 1:
        raise ValueError(f"paged_prefill needs q_tile >= 1, got {q_tile}")
    tiles = cached_prefill_tiles(seq_idx, pos, q_tile, S)
    tables, pos = _i32(block_tables), _i32(pos)
    lib = kernel_build().lib
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ds_paged_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        k_scale.stride(0) if quant else 0, tables.data_ptr(), pos.data_ptr(),
        *[t.data_ptr() for t in tiles], _ptr(alibi), out.data_ptr(), tiles[0].shape[0], T, nq,
        nkv, d, block_size, max_blocks, _window(window), q_tile, int(quant), stream)
    _raise_if(rc, "paged_prefill")
    launch_counts["paged_prefill"] += 1
    return out
