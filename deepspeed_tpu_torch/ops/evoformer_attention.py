"""Evoformer biased flash attention, forward and backward with both bias
gradients, for PyTorch on an NVIDIA H100.

Counterpart of ``deepspeed_tpu/ops/pallas/evoformer_attention.py``, the
kernels behind ``DS4Sci_EvoformerAttention``. :func:`evo_flash` takes q/k/v
``[N, R, h, d]``, the mask bias ``bias1 [N, R]`` and the pair bias
``bias2 [G, h, R, R]`` (shared by the ``n_seq = N // G`` rows of a group;
either bias may be None) and is a ``torch.autograd.Function``: the forward
saves ``lse [N, h, R]`` fp32, the backward returns dq, dk, dv, db1 and db2,
with None for an absent bias and that bias's pass skipped.

- :func:`evo_attention_reference` and :func:`evo_attention_reference_bwd`
  are the plain PyTorch versions (fp32 einsums over the whole ``[R, R]``
  score matrix, the same recurrences): the CPU path and the numerics oracle.
- :func:`evo_fwd`, :func:`evo_bwd_dq`, :func:`evo_bwd_dkdv` (dk, dv and the
  mask bias's db1, summed in the same CTA) and :func:`evo_bwd_db2` wrap the
  hand-written CUDA kernels of ``csrc/evoformer_attention.cu``. On a CPU
  tensor they return the plain version; on a CUDA tensor they launch their
  kernel or raise.

The kernels take head_dim 32, 64 or 128 (``HEAD_DIMS``), bf16, fp16 or fp32
q/k/v, and any R (ragged tiles are masked inside them). The TPU package's
tile fitting (``_fit_block``, ``_fit_tiles`` and the VMEM budget), its
``block_q`` / ``block_k`` knobs and the ``interpret`` flag are not ported:
the CUDA tiles are fixed and a launch either runs or raises.

Every kernel has two routes, chosen by :func:`route` from q/k/v's dtype
alone (never on a failure): ``"mma"`` for bf16 and fp16 (the tensor cores:
``ds_evo_fwd``, ``ds_evo_bwd_dq``, ``ds_evo_bwd_dkdv``, ``ds_evo_bwd_db2``)
and ``"fp32"`` for float32 (the first version's CUDA-core kernels, the same
names with ``_fp32``, whose fp32 sums hold a tolerance the 16-bit products
cannot). On the tensor cores db2 splits each group's rows into
:func:`db2_row_chunks` chunks so that its grid fills the card; the chunks'
partials go to a scratch tensor and the kernel library sums them in chunk
order.

``launch_counts`` counts kernel launches, one entry per TPU kernel and
route (``_fp32`` for the CUDA-core route): ``evo_bwd_db1`` counts the dk/dv
launches that also sum db1 (the TPU package's separate ``db1_kernel``).
Nothing else adds to it.
"""

import ctypes
import math

import torch

from ._build import build_kernel

MASK_VALUE = -1e30
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

_SUFFIX = {"mma": "", "fp32": "_fp32"}  # route -> suffix of its C entry points and counts
launch_counts = {f"evo_{k}{sfx}": 0 for sfx in _SUFFIX.values()
                 for k in ("fwd", "bwd_dq", "bwd_dkdv", "bwd_db1", "bwd_db2")}
SMS = 132  # streaming multiprocessors of an H100 SXM
DB2_CTAS_PER_SM = 16  # db2's grid: about this many CTAs for every SM

_built = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_build():
    """Build (first call) and return the kernel library (``.lib``,
    ``.seconds`` nvcc's wall time, ``.ptxas`` its report)."""
    global _built
    if _built is None:
        built = build_kernel("evoformer_attention")
        lib = built.lib
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_evo_fwd.argtypes = [vp] * 7 + [i] * 6 + [vp]
        lib.ds_evo_fwd_fp32.argtypes = [vp] * 7 + [i] * 6 + [vp]
        lib.ds_evo_bwd_dq.argtypes = [vp] * 9 + [i] * 6 + [vp]
        lib.ds_evo_bwd_dq_fp32.argtypes = [vp] * 9 + [i] * 6 + [vp]
        lib.ds_evo_bwd_dkdv.argtypes = [vp] * 11 + [i] * 6 + [vp]
        lib.ds_evo_bwd_dkdv_fp32.argtypes = [vp] * 11 + [i] * 6 + [vp]
        lib.ds_evo_bwd_db2.argtypes = [vp] * 10 + [i] * 7 + [vp]
        lib.ds_evo_bwd_db2_fp32.argtypes = [vp] * 9 + [i] * 6 + [vp]
        for fn in (lib.ds_evo_fwd, lib.ds_evo_fwd_fp32, lib.ds_evo_bwd_dq,
                   lib.ds_evo_bwd_dq_fp32, lib.ds_evo_bwd_dkdv, lib.ds_evo_bwd_dkdv_fp32,
                   lib.ds_evo_bwd_db2, lib.ds_evo_bwd_db2_fp32):
            fn.restype = i
        lib.ds_evo_error_string.argtypes = [i]
        lib.ds_evo_error_string.restype = ctypes.c_char_p
        lib.ds_evo_smem_bytes.argtypes = [i, i]
        lib.ds_evo_smem_bytes.restype = ctypes.c_longlong
        _built = built
    return _built


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _add_biases(s, bias1, bias2):
    """s [N, h, R, R] fp32 + bias2[n // n_seq, h] + bias1[n], in the TPU
    kernel's order ((s + b2) + b1)."""
    N, h, R, _ = s.shape
    if bias2 is not None:
        G = bias2.shape[0]
        s = (s.reshape(G, N // G, h, R, R) + bias2.float()[:, None]).reshape(N, h, R, R)
    if bias1 is not None:
        s = s + bias1.float()[:, None, None, :]
    return s


def evo_attention_reference(q, k, v, bias1=None, bias2=None):
    """(out [N, R, h, d] in q's dtype, lse [N, h, R] fp32): q pre-scaled,
    the row max floored at -1e30 and the row sum at 1e-30 as the kernels'
    online softmax does, so a row whose biases are all -inf gives 0."""
    d = q.shape[-1]
    s = torch.einsum("nqhd,nkhd->nhqk", q.float() * (1.0 / math.sqrt(d)), k.float())
    s = _add_biases(s, bias1, bias2)
    m = s.amax(dim=-1, keepdim=True).clamp_min(MASK_VALUE)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("nhqk,nkhd->nqhd", p, v.float()) / l_safe.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def evo_attention_reference_bwd(q, k, v, bias1, bias2, out, lse, dout):
    """(dq, dk, dv, db1, db2) by the TPU kernels' recurrences on the whole
    score matrix: s = scale * (q . k) + b2 + b1, p = exp(s - lse),
    delta = rowsum(dO * O) of the stored ``out``, ds = p * (dO . v - delta).
    db1 [N, R] and db2 [G, h, R, R] are fp32, None for an absent bias."""
    N, R, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = _add_biases(scale * torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()), bias1, bias2)
    p = torch.exp(s - lse[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)[..., None]  # [N, h, R, 1]
    ds = p * (torch.einsum("nqhd,nkhd->nhqk", do, v.float()) - delta)
    dv = torch.einsum("nhqk,nqhd->nkhd", p, do)
    dk = scale * torch.einsum("nhqk,nqhd->nkhd", ds, q.float())
    dq = scale * torch.einsum("nhqk,nkhd->nqhd", ds, k.float())
    db1 = ds.sum(dim=(1, 2)) if bias1 is not None else None
    db2 = None
    if bias2 is not None:
        G = bias2.shape[0]
        db2 = ds.reshape(G, N // G, h, R, R).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), db1, db2


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def route(dtype) -> str:
    """The kernels' route for q/k/v of ``dtype``: ``"mma"`` (tensor cores)
    for bfloat16 and float16, ``"fp32"`` (CUDA cores) for float32."""
    if dtype not in DTYPES:
        raise ValueError(f"the kernels take bfloat16, float16 or float32, got {dtype}")
    return "fp32" if dtype == torch.float32 else "mma"


def db2_row_chunks(n_seq: int, R: int, h: int, G: int) -> int:
    """How many chunks the tensor-core db2 splits each group's ``n_seq``
    rows into: its grid has ``tiles^2 * h * G`` CTAs a chunk (64-wide
    query and key tiles), and enough chunks give about
    ``DB2_CTAS_PER_SM`` CTAs to each of the card's ``SMS`` SMs, at most one
    a row; 1 where the grid already fills the card."""
    tiles = -(-R // 64)
    per_chunk = tiles * tiles * h * G
    return max(1, min(n_seq, -(-DB2_CTAS_PER_SM * SMS // per_chunk)))


def chunk_rows(n_seq: int, n_chunks: int):
    """The rows ``[lo, hi)`` of each chunk of a group, in order, as the
    kernel computes them (chunk c: ``c * n_seq // n_chunks`` up to
    ``(c + 1) * n_seq // n_chunks``)."""
    return [(c * n_seq // n_chunks, (c + 1) * n_seq // n_chunks) for c in range(n_chunks)]


def _check(q, k, v, bias1, bias2):
    """(N, R, h, d, n_seq) of a kernel call; raises on what the kernels do
    not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [N, R, h, d] of one shape, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    N, R, h, d = q.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernels take bfloat16, float16 or float32 q/k/v of one dtype, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported: the kernels are built for {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias1", bias1), ("bias2", bias2)):
        if t is not None and (not t.is_cuda or t.device != q.device):
            raise ValueError(f"{name} must lie on q's CUDA device")
    if bias1 is not None and (bias1.shape != (N, R) or bias1.dtype != torch.float32):
        raise ValueError(f"bias1 must be fp32 [N, R] = {(N, R)}, got {tuple(bias1.shape)} "
                         f"{bias1.dtype}")
    n_seq = N
    if bias2 is not None:
        G = bias2.shape[0]
        if N % G or bias2.shape != (G, h, R, R) or bias2.dtype != torch.float32:
            raise ValueError(f"bias2 must be fp32 [G, h, R, R] with G dividing N={N}, got "
                             f"{tuple(bias2.shape)} {bias2.dtype}")
        n_seq = N // G
    return N, R, h, d, n_seq


def _contig(*ts):
    out = []
    for t in ts:
        if t is not None:
            t = t.contiguous()
            if t.data_ptr() % 16:
                raise ValueError("kernel operands must be 16-byte aligned")
        out.append(t)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_if(rc: int, name: str) -> None:
    if rc:
        msg = kernel_build().lib.ds_evo_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def evo_fwd(q, k, v, bias1=None, bias2=None):
    """(out, lse). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return evo_attention_reference(q, k, v, bias1, bias2)
    N, R, h, d, n_seq = _check(q, k, v, bias1, bias2)
    q, k, v, bias1, bias2 = _contig(q, k, v, bias1, bias2)
    out = torch.empty_like(q)
    lse = torch.empty((N, h, R), dtype=torch.float32, device=q.device)
    sfx = _SUFFIX[route(q.dtype)]
    rc = getattr(kernel_build().lib, f"ds_evo_fwd{sfx}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias1), _ptr(bias2), out.data_ptr(),
        lse.data_ptr(), N, R, h, d, n_seq, DTYPES[q.dtype], _stream(q))
    _raise_if(rc, f"evo_fwd{sfx}")
    launch_counts[f"evo_fwd{sfx}"] += 1
    return out, lse


def _bwd_operands(q, k, v, bias1, bias2, out, lse, dout):
    dims = _check(q, k, v, bias1, bias2)
    N, R, h, _, _ = dims
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("out and dout must have q's shape (out also its dtype)")
    if lse.shape != (N, h, R) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [N, h, R] = {(N, h, R)}")
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
    return dims, _contig(q, k, v, bias1, bias2, out, dout.to(q.dtype), lse)


def evo_bwd_dq(q, k, v, bias1, bias2, out, lse, dout):
    """dq in q's dtype. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return evo_attention_reference_bwd(q, k, v, bias1, bias2, out, lse, dout)[0]
    (N, R, h, d, n_seq), (q, k, v, bias1, bias2, out, dout, lse) = _bwd_operands(
        q, k, v, bias1, bias2, out, lse, dout)
    dq = torch.empty_like(q)
    sfx = _SUFFIX[route(q.dtype)]
    rc = getattr(kernel_build().lib, f"ds_evo_bwd_dq{sfx}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), _ptr(bias1), _ptr(bias2), dq.data_ptr(), N, R, h, d, n_seq,
        DTYPES[q.dtype], _stream(q))
    _raise_if(rc, f"evo_bwd_dq{sfx}")
    launch_counts[f"evo_bwd_dq{sfx}"] += 1
    return dq


def evo_bwd_dkdv(q, k, v, bias1, bias2, out, lse, dout, db1=True):
    """(dk, dv, db1): dk / dv in k's dtype, db1 [N, R] fp32 when ``bias1``
    is given and ``db1`` is true, else None. CPU tensors take the plain
    version."""
    want_db1 = bias1 is not None and db1
    if q.device.type == "cpu":
        _, dk, dv, g1, _ = evo_attention_reference_bwd(q, k, v, bias1, bias2, out, lse, dout)
        return dk, dv, g1 if want_db1 else None
    (N, R, h, d, n_seq), (q, k, v, bias1, bias2, out, dout, lse) = _bwd_operands(
        q, k, v, bias1, bias2, out, lse, dout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    g1 = torch.empty((N, R), dtype=torch.float32, device=q.device) if want_db1 else None
    sfx = _SUFFIX[route(q.dtype)]
    rc = getattr(kernel_build().lib, f"ds_evo_bwd_dkdv{sfx}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), _ptr(bias1), _ptr(bias2), dk.data_ptr(), dv.data_ptr(), _ptr(g1), N, R,
        h, d, n_seq, DTYPES[q.dtype], _stream(q))
    _raise_if(rc, f"evo_bwd_dkdv{sfx}")
    launch_counts[f"evo_bwd_dkdv{sfx}"] += 1
    if want_db1:
        launch_counts[f"evo_bwd_db1{sfx}"] += 1
    return dk, dv, g1


def evo_bwd_db2(q, k, v, bias1, bias2, out, lse, dout):
    """db2 [G, h, R, R] fp32 (``bias2`` is required). CPU tensors take the
    plain version."""
    if bias2 is None:
        raise ValueError("db2 needs the pair bias bias2")
    if q.device.type == "cpu":
        return evo_attention_reference_bwd(q, k, v, bias1, bias2, out, lse, dout)[4]
    (N, R, h, d, n_seq), (q, k, v, bias1, bias2, out, dout, lse) = _bwd_operands(
        q, k, v, bias1, bias2, out, lse, dout)
    G = N // n_seq
    db2 = torch.empty((G, h, R, R), dtype=torch.float32, device=q.device)
    lib = kernel_build().lib
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), _ptr(bias1), _ptr(bias2), db2.data_ptr())
    sfx = _SUFFIX[route(q.dtype)]
    if sfx == _SUFFIX["mma"]:
        n_chunks = db2_row_chunks(n_seq, R, h, G)
        # freed on return, before the kernels run: the caching allocator
        # hands the block out again only to work queued on this stream after
        # them
        scratch = (torch.empty((n_chunks, G, h, R, R), dtype=torch.float32, device=q.device)
                   if n_chunks > 1 else None)
        rc = lib.ds_evo_bwd_db2(*args, _ptr(scratch), N, R, h, d, n_seq, n_chunks,
                                DTYPES[q.dtype], _stream(q))
    else:
        rc = lib.ds_evo_bwd_db2_fp32(*args, N, R, h, d, n_seq, DTYPES[q.dtype], _stream(q))
    _raise_if(rc, f"evo_bwd_db2{sfx}")
    launch_counts[f"evo_bwd_db2{sfx}"] += 1
    return db2


class EvoFlash(torch.autograd.Function):
    """Forward saves (q, k, v, biases, out, lse); backward runs dq, dk/dv
    (with db1 when the mask bias is present) and db2 (when the pair bias
    is). On CPU tensors the backward is one call of the plain version,
    whose five results are split."""

    @staticmethod
    def forward(ctx, q, k, v, bias1, bias2):
        out, lse = evo_fwd(q, k, v, bias1, bias2)
        ctx.save_for_backward(q, k, v, bias1, bias2, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias1, bias2, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return evo_attention_reference_bwd(q, k, v, bias1, bias2, out, lse, dout)
        dq = evo_bwd_dq(q, k, v, bias1, bias2, out, lse, dout)
        dk, dv, db1 = evo_bwd_dkdv(q, k, v, bias1, bias2, out, lse, dout)
        db2 = None if bias2 is None else evo_bwd_db2(q, k, v, bias1, bias2, out, lse, dout)
        return dq, dk, dv, db1, db2


def evo_flash(q, k, v, bias1=None, bias2=None):
    """q/k/v: [N, R, h, d]; bias1: [N, R] or None; bias2: [G, h, R, R]
    (N % G == 0) or None. Returns [N, R, h, d] in q's dtype. Differentiable
    in every present operand; the biases are taken in fp32 (their
    gradients come back in their own dtype)."""
    N, R, h, d = q.shape
    if bias1 is not None:
        if bias1.shape != (N, R):
            raise ValueError(f"bias1 {tuple(bias1.shape)} != {(N, R)}")
        bias1 = bias1.float()
    if bias2 is not None:
        G = bias2.shape[0]
        if N % G:
            raise ValueError(f"N={N} must be a multiple of bias2 groups G={G}")
        if bias2.shape != (G, h, R, R):
            raise ValueError(f"bias2 {tuple(bias2.shape)} != {(G, h, R, R)}")
        bias2 = bias2.float()
    return EvoFlash.apply(q, k, v, bias1, bias2)
