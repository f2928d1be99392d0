"""Block-sparse attention over a static sparsity layout, for PyTorch on an
NVIDIA H100.

Counterpart of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``. A
layout is a host numpy ``(H, nb, nb)`` 0/1 array from a
:class:`~deepspeed_tpu_torch.ops.sparse_attention.SparsityConfig`;
:func:`make_layout_lut` compresses it into per-(head, row) column LUTs.

- :func:`block_sparse_attention_gathered` is the plain PyTorch version: a
  LUT gather of the active K/V blocks, O(B·H·L·A·block) memory, never the
  dense score matrix. The CPU path, the numerics oracle and the backward.
- :func:`block_sparse_fwd` wraps the hand-written CUDA kernels of
  ``csrc/block_sparse_attention.cu``: bfloat16 and float16 take the
  tensor-core kernel (``ds_block_sparse_fwd``), float32 the CUDA-core one
  (``ds_block_sparse_fwd_fp32``), as :func:`route` says. On a CPU tensor it
  returns the plain version; on a CUDA tensor it launches its route's
  kernel or raises.
- :func:`block_sparse_attention` is the public entry, a
  ``torch.autograd.Function``: the forward is :func:`block_sparse_fwd`, the
  backward recomputes through the gathered form (as the JAX ``custom_vjp``
  does, ``:182-188``), one chunk of heads at a time so its gathered K/V stay
  near ``BWD_CHUNK_BYTES``. ``rpe``, ``key_padding_mask`` and ``attn_mask``
  are inputs of the Function, so a trainable rpe gets its gradient.

Mask semantics are the JAX package's: ``rpe`` is added to the scaled
scores; ``key_padding_mask`` ([B, L]) and ``attn_mask`` ([L, L]) are added
in ``'add'`` mode, while ``'mul'`` mode reads them as 0/1 indicators (0 ->
-1e30); ``causal=True`` applies the token-level causal mask inside diagonal
blocks. The JAX wrapper's fallback to the gathered form when its kernel
fails is not ported: a CUDA launch either runs or raises.

``launch_counts`` counts kernel launches by route (``block_sparse_fwd``,
``block_sparse_fwd_fp32``); nothing else adds to it.
"""

import ctypes
import math

import numpy as np
import torch

from ._build import build_kernel

_NEG_INF = -1e30
# the backward's recompute works on chunks of heads whose gathered K (and
# V, and their gradients) hold about this many bytes each
BWD_CHUNK_BYTES = 1 << 30

_SUFFIX = {"mma": "", "fp32": "_fp32"}  # route -> suffix of its C entry point and count
launch_counts = {f"block_sparse_fwd{sfx}": 0 for sfx in _SUFFIX.values()}

# the union walk's descriptor format, as the kernel source reads it
# (kTileRows, kColBits)
TILE_ROWS = 64  # query rows of a tensor-core CTA: 4 warps x 16
_COL_BITS = 24  # a union entry: column | warp membership bits << _COL_BITS

_built = None
_union_memo = None
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_MODES = ("add", "mul")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_build():
    """Build (first call) and return the kernel library (``.lib``,
    ``.seconds`` nvcc's wall time, ``.ptxas`` its report)."""
    global _built
    if _built is None:
        built = build_kernel("block_sparse_attention")
        lib = built.lib
        vp, i = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"ds_block_sparse_fwd{sfx}")
            fn.argtypes = [vp] * 10 + [i] * 7 + [ctypes.c_float] + [i] * 3 + [vp]
            fn.restype = i
        lib.ds_block_sparse_error_string.argtypes = [i]
        lib.ds_block_sparse_error_string.restype = ctypes.c_char_p
        lib.ds_block_sparse_smem_bytes.argtypes = [i, i]
        lib.ds_block_sparse_smem_bytes.restype = ctypes.c_longlong
        lib.ds_block_sparse_union_walk.argtypes = []
        lib.ds_block_sparse_union_walk.restype = i
        _built = built
    return _built


def route(dtype) -> str:
    """The kernel's route for q/k/v of ``dtype``: ``"mma"`` (tensor cores)
    for bfloat16 and float16, ``"fp32"`` (CUDA cores) for float32."""
    if dtype not in _DTYPES:
        raise ValueError(f"the kernels take bfloat16, float16 or float32, got {dtype}")
    return "fp32" if dtype == torch.float32 else "mma"


def make_layout_lut(layout):
    """Compress a (H, nb, nb) 0/1 layout into per-row column LUTs.

    Returns ``(lut, nvalid)`` numpy int32: ``lut`` [H, nb, A] lists each
    row's active column-block indices (A = densest row in the whole layout),
    padded by repeating the row's last valid column; ``nvalid`` [H, nb] is
    the true count. Rows with no active blocks get nvalid 0 (output is
    zeros). The same values as the JAX package's (``:45``)."""
    layout = np.asarray(layout)
    H, nb, _ = layout.shape
    counts = layout.sum(axis=-1).astype(np.int32)  # [H, nb]
    A = max(1, int(counts.max()))
    lut = np.zeros((H, nb, A), dtype=np.int32)
    for h in range(H):
        for r in range(nb):
            cols = np.nonzero(layout[h, r])[0]
            if len(cols):
                lut[h, r, :len(cols)] = cols
                lut[h, r, len(cols):] = cols[-1]
    return lut, counts


def union_plan(lut, nvalid, block: int, L: int):
    """The union walk's descriptor: for each head and each tile of
    ``TILE_ROWS`` query rows (warp ``w`` owns rows ``64 t + 16 w ..
    + 15``, in block row ``(64 t + 16 w) // block``), the union of its
    warps' rows' valid LUT columns (the first ``nvalid``), ascending, each
    entry ``column | bits << 24`` where bit ``w`` says that warp ``w``'s row
    holds the column. Returns int32 ``(entries [H, tiles, U], count [H,
    tiles])`` on ``lut``'s device (U the largest count, at least 1; entries
    past a tile's count are never read)."""
    H, nb, A = lut.shape
    dev = lut.device
    lut = lut.long()
    n_tiles = -(-L // TILE_ROWS)
    rows = (torch.arange(n_tiles, device=dev)[:, None] * TILE_ROWS
            + torch.arange(TILE_ROWS // 16, device=dev) * 16)  # [tiles, warps]
    live = rows < L
    rw = torch.clamp(rows // block, max=nb - 1)
    valid = torch.arange(A, device=dev) < nvalid.long()[..., None]  # [H, nb, A]
    bits = torch.zeros(H, n_tiles, nb, dtype=torch.int32, device=dev)
    for w in range(TILE_ROWS // 16):  # a row's valid columns are distinct: one bit each
        on = valid[:, rw[:, w]] & live[None, :, w, None]
        bits.scatter_add_(-1, lut[:, rw[:, w]], on.int() << w)
    count = (bits > 0).sum(-1)
    U = max(1, int(count.max()))
    cols = torch.sort((bits == 0).to(torch.int8), dim=-1, stable=True).indices[..., :U]
    entries = cols | (bits.gather(-1, cols) << _COL_BITS)
    return entries.to(torch.int32).contiguous(), count.to(torch.int32).contiguous()


def cached_union_plan(lut, nvalid, block: int, L: int):
    """:func:`union_plan`, reused while ``lut`` and ``nvalid`` are the same
    tensor objects, unmodified (their in-place version counters unchanged),
    with the same ``block`` and ``L``: a layout's LUT tensors are cached by
    their callers (``SparseSelfAttention._lut_cache``, the model's layout
    cache), so every layer and step of one layout builds it once. The memo
    holds those tensors."""
    global _union_memo
    key = (lut._version, nvalid._version, int(block), int(L))
    m = _union_memo
    if m is None or m[0] is not lut or m[1] is not nvalid or m[2] != key:
        m = _union_memo = (lut, nvalid, key, union_plan(lut, nvalid, block, L))
    return m[3]


def _mask_to_bias(m, mode):
    m = m.float()
    if mode == "mul":
        return torch.where(m == 0, torch.full_like(m, _NEG_INF), torch.zeros_like(m))
    if mode == "add":
        return m
    raise ValueError(f"unknown mask mode {mode!r} (expected 'add' or 'mul')")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _gather_2d(mat, lut, nb, block):
    """[L, L] -> per-(head, row) gathered blocks [H, nb, block, A, block],
    ordered to broadcast against scores [., H, nb, block, A, block]."""
    blk = mat.reshape(nb, block, nb, block).permute(0, 2, 1, 3)  # [nb, nb, block, block]
    g = blk[torch.arange(nb, device=mat.device)[None, :, None], lut]  # [H, nb, A, block, block]
    return g.permute(0, 1, 3, 2, 4)


def block_sparse_attention_gathered(q, k, v, lut, nvalid, block, *, causal=False, scale=None,
                                    rpe=None, key_padding_mask=None, attn_mask=None,
                                    key_padding_mask_mode="add", attn_mask_mode="mul"):
    """LUT-gather block-sparse attention (``:78-122``), differentiable by
    autograd. q/k/v: [B, H, L, d]; lut/nvalid from :func:`make_layout_lut`
    (numpy or tensors). Returns [B, H, L, d] in q's dtype."""
    B, H, L, d = q.shape
    nb = L // block
    dev = q.device
    lut = torch.as_tensor(lut, device=dev).long()
    nvalid = torch.as_tensor(nvalid, device=dev).long()
    A = lut.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale

    qb = q.float().reshape(B, H, nb, block, d) * scale
    kb = k.float().reshape(B, H, nb, block, d)
    vb = v.float().reshape(B, H, nb, block, d)
    hidx = torch.arange(H, device=dev)[:, None, None]
    kg = kb[:, hidx, lut]  # [B, H, nb, A, block, d]
    vg = vb[:, hidx, lut]

    s = torch.einsum("bhrqd,bhrjkd->bhrqjk", qb, kg)  # [B, H, nb, block, A, block]

    j_valid = torch.arange(A, device=dev)[None, None, :] < nvalid[:, :, None]  # [H, nb, A]
    vis = j_valid[None, :, :, None, :, None]
    if causal:
        ar = torch.arange(block, device=dev)
        qpos = torch.arange(nb, device=dev)[:, None] * block + ar[None, :]  # [nb, block]
        kpos = lut[..., None] * block + ar  # [H, nb, A, block]
        vis = vis & (kpos[None, :, :, None, :, :] <= qpos[None, None, :, :, None, None])
    if rpe is not None:
        s = s + _gather_2d(rpe.float(), lut, nb, block)[None]
    if key_padding_mask is not None:
        kpb = _mask_to_bias(key_padding_mask, key_padding_mask_mode).reshape(B, nb, block)
        s = s + kpb[:, lut][:, :, :, None, :, :]  # [B, H, nb, 1, A, block]
    if attn_mask is not None:
        s = s + _gather_2d(_mask_to_bias(attn_mask, attn_mask_mode), lut, nb, block)[None]

    s = torch.where(vis, s, _NEG_INF)
    flat = s.reshape(B, H, nb, block, A * block)
    m = flat.amax(dim=-1, keepdim=True)
    # fully-masked rows (empty layout row / all padding) produce zeros, not NaN
    p = torch.where(flat > _NEG_INF / 2, torch.exp(flat - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = (p / denom).reshape(s.shape)
    out = torch.einsum("bhrqjk,bhrjkd->bhrqd", p, vg)
    return out.reshape(B, H, L, d).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _strides(t):
    """(batch, head, row) strides of a [B, H, L, d] operand the kernel reads
    in place: the last dimension contiguous, 16-byte rows. Else a copy."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    return t, list(t.stride()[:3])


def _fp32_operand(t, shape, name, device):
    if t is None:
        return None
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name} must be {list(shape)} on q's device, got {tuple(t.shape)} on "
                         f"{t.device}")
    t = t.float().contiguous()
    return t if t.data_ptr() % 8 == 0 else t.clone()  # the kernel reads two keys a float2


def block_sparse_fwd(q, k, v, lut, nvalid, block, *, causal=False, scale=None, rpe=None,
                     key_padding_mask=None, attn_mask=None, key_padding_mask_mode="add",
                     attn_mask_mode="mul"):
    """[B, H, L, d] in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel of ``route(q.dtype)`` (int32 ``lut`` /
    ``nvalid`` on q's device) or raise."""
    kw = dict(causal=causal, scale=scale, rpe=rpe, key_padding_mask=key_padding_mask,
              attn_mask=attn_mask, key_padding_mask_mode=key_padding_mask_mode,
              attn_mask_mode=attn_mask_mode)
    if q.device.type == "cpu":
        return block_sparse_attention_gathered(q, k, v, lut, nvalid, block, **kw)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, H, L, d] of one shape, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, H, L, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes bfloat16, float16 or float32 q/k/v of one dtype, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (32, 64, 128):
        raise ValueError(f"head_dim {d} unsupported: the kernel is built for 32, 64 and 128")
    if block % 16 or L % block:
        raise ValueError(f"block {block} must be a multiple of 16 that divides L = {L}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
    nb = L // block
    if (not torch.is_tensor(lut) or lut.dtype != torch.int32 or lut.device != q.device
            or lut.dim() != 3 or tuple(lut.shape[:2]) != (H, nb) or not lut.is_contiguous()):
        raise ValueError(f"lut must be a contiguous int32 [H={H}, nb={nb}, A] tensor on q's device")
    if (not torch.is_tensor(nvalid) or nvalid.dtype != torch.int32 or nvalid.device != q.device
            or tuple(nvalid.shape) != (H, nb) or not nvalid.is_contiguous()):
        raise ValueError(f"nvalid must be a contiguous int32 [H={H}, nb={nb}] tensor on q's device")
    if key_padding_mask_mode not in _MODES or attn_mask_mode not in _MODES:
        raise ValueError(f"mask modes must be 'add' or 'mul', got {key_padding_mask_mode!r} / "
                         f"{attn_mask_mode!r}")
    rpe = _fp32_operand(rpe, (L, L), "rpe", q.device)
    kp = _fp32_operand(key_padding_mask, (B, L), "key_padding_mask", q.device)
    am = _fp32_operand(attn_mask, (L, L), "attn_mask", q.device)
    (q, qs), (k, ks), (v, vs) = _strides(q), _strides(k), _strides(v)
    out = torch.empty((B, L, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*qs, *ks, *vs, *out.stride()[:3])
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    sfx = _SUFFIX[route(q.dtype)]
    lib = kernel_build().lib
    if not sfx and lib.ds_block_sparse_union_walk():  # it reads the descriptor in their place
        lut, nvalid = cached_union_plan(lut, nvalid, block, L)
    rc = getattr(lib, f"ds_block_sparse_fwd{sfx}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lut.data_ptr(),
        nvalid.data_ptr(), ptr(rpe), ptr(kp), ptr(am), strides, B, H, L, d, block,
        lut.shape[-1], int(causal), scale, int(key_padding_mask_mode == "mul"),
        int(attn_mask_mode == "mul"), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        msg = lib.ds_block_sparse_error_string(rc).decode()
        raise RuntimeError(f"block_sparse_fwd{sfx} kernel launch failed: {msg} (cudaError {rc})")
    launch_counts[f"block_sparse_fwd{sfx}"] += 1
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _recompute_grads(saved, dout, needs, opts):
    """The gathered form's vjp for the inputs in ``needs`` (q, k, v, rpe,
    key_padding_mask, attn_mask), over chunks of heads: heads are
    independent, so the chunks' q/k/v gradients are slices of the whole and
    the shared operands' gradients sum over them."""
    q, k, v, rpe, kp, am, lut, nvalid = saved
    B, H, L, d = q.shape
    per_head = B * lut.shape[1] * lut.shape[2] * opts["block"] * d * 4
    hc = max(1, min(H, BWD_CHUNK_BYTES // max(per_head, 1)))
    head_grads = [[] for _ in range(3)]
    shared = [None, None, None]
    for h0 in range(0, H, hc):
        sl = slice(h0, h0 + hc)
        with torch.enable_grad():
            qkv = [t[:, sl].detach().requires_grad_(need) for t, need in zip((q, k, v), needs)]
            ext = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip((rpe, kp, am), needs[3:])]
            out = block_sparse_attention_gathered(
                *qkv, lut[sl], nvalid[sl], opts["block"], causal=opts["causal"],
                scale=opts["scale"], rpe=ext[0], key_padding_mask=ext[1], attn_mask=ext[2],
                key_padding_mask_mode=opts["kp_mode"], attn_mask_mode=opts["am_mode"])
            inputs = [t for t, need in zip(qkv + ext, needs) if need]
            grads = iter(torch.autograd.grad(out, inputs, dout[:, sl], allow_unused=True))
        for i, need in enumerate(needs):
            if not need:
                continue
            g = next(grads)
            if i < 3:
                head_grads[i].append(g)
            else:
                t = (rpe, kp, am)[i - 3]
                g = torch.zeros_like(t) if g is None else g
                shared[i - 3] = g if shared[i - 3] is None else shared[i - 3] + g
    return ([torch.cat(g, dim=1) if g else None for g in head_grads] + shared)


class BlockSparseAttention(torch.autograd.Function):
    """Forward: :func:`block_sparse_fwd`; backward: the gathered form's
    vjp, recomputed (no O(L^2) residuals)."""

    @staticmethod
    def forward(ctx, q, k, v, rpe, key_padding_mask, attn_mask, lut, nvalid, block, causal,
                scale, kp_mode, am_mode):
        out = block_sparse_fwd(q, k, v, lut, nvalid, block, causal=causal, scale=scale, rpe=rpe,
                               key_padding_mask=key_padding_mask, attn_mask=attn_mask,
                               key_padding_mask_mode=kp_mode, attn_mask_mode=am_mode)
        ctx.save_for_backward(q, k, v, rpe, key_padding_mask, attn_mask, lut, nvalid)
        ctx.opts = dict(block=block, causal=causal, scale=scale, kp_mode=kp_mode,
                        am_mode=am_mode)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _recompute_grads(ctx.saved_tensors, dout, list(ctx.needs_input_grad[:6]),
                                 ctx.opts)
        return (*grads, None, None, None, None, None, None, None)


def block_sparse_attention(q, k, v, layout, block, *, causal=False, scale=None, rpe=None,
                           key_padding_mask=None, attn_mask=None, key_padding_mask_mode="add",
                           attn_mask_mode="mul", lut=None, nvalid=None):
    """Public entry. q/k/v: [B, H, L, d] (any strides; the kernel reads
    them in place when their last dimension is contiguous). ``layout``:
    host numpy (H, nb, nb) 0/1. Callers that reuse a layout pass a
    precomputed ``(lut, nvalid)`` (numpy, or int32 tensors on q's device to
    skip the copy). Returns [B, H, L, d] in q's dtype."""
    if lut is None or nvalid is None:
        lut, nvalid = make_layout_lut(layout)
    for mode in (key_padding_mask_mode, attn_mask_mode):
        if mode not in _MODES:
            raise ValueError(f"unknown mask mode {mode!r} (expected 'add' or 'mul')")
    lut = torch.as_tensor(lut, dtype=torch.int32, device=q.device).contiguous()
    nvalid = torch.as_tensor(nvalid, dtype=torch.int32, device=q.device).contiguous()
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return BlockSparseAttention.apply(q, k, v, rpe, key_padding_mask, attn_mask, lut, nvalid,
                                      int(block), bool(causal), scale, key_padding_mask_mode,
                                      attn_mask_mode)
