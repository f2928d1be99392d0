"""Flash attention for training, forward and backward, for PyTorch on an
NVIDIA H100.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``.
:func:`flash_attention` takes ``[B, S, n, d]`` q/k/v (GQA: nkv divides nq)
and is a ``torch.autograd.Function``: the forward returns the output and
saves ``lse [B, nq, S]`` fp32; the backward runs dq first, which also
writes ``delta = rowsum(dO * O)`` as fp32 ``[B, nq, S]``, then dk/dv,
which reads lse and delta and never the output. On CPU tensors the
backward is one call of the plain version.

- :func:`flash_attention_reference` and :func:`flash_attention_reference_bwd`
  are the plain PyTorch versions (fp32 einsums over the whole score matrix,
  the same recurrences): the CPU path and the numerics oracle.
- :func:`flash_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkdv` wrap the
  hand-written CUDA kernels of ``csrc/flash_attention.cu``. On a CPU tensor
  they return the plain version; on a CUDA tensor they launch their kernel
  or raise. ``flash_bwd_dq`` returns ``(dq, delta)``, and ``flash_bwd_dkdv``
  takes that ``delta`` in place of the output.

Any sequence length works (ragged tiles are masked inside the kernels).
ALiBi takes the slope table of ``models.transformer.alibi_slopes``, so head
counts that are not powers of two get the same slopes as the JAX package's
reference path. The TPU package's environment switch, VMEM tile fitting and
retry ladder are not ported: a CUDA launch either runs or raises.

``launch_counts`` counts kernel launches per kernel; nothing else adds to it.
"""

import ctypes
import math

import torch

from ._build import build_kernel

MASK_VALUE = -1e30

launch_counts = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

_built = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_build():
    """Build (first call) and return the kernel library (``.lib``,
    ``.seconds`` nvcc's wall time, ``.ptxas`` its report)."""
    global _built
    if _built is None:
        built = build_kernel("flash_attention")
        lib = built.lib
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_flash_fwd.argtypes = [vp] * 6 + [i] * 8 + [vp]
        lib.ds_flash_fwd.restype = i
        lib.ds_flash_bwd_dkdv.argtypes = [vp] * 9 + [i] * 8 + [vp]
        lib.ds_flash_bwd_dkdv.restype = i
        lib.ds_flash_bwd_dq.argtypes = [vp] * 9 + [i] * 8 + [vp]
        lib.ds_flash_bwd_dq.restype = i
        lib.ds_flash_error_string.argtypes = [i]
        lib.ds_flash_error_string.restype = ctypes.c_char_p
        lib.ds_flash_smem_bytes.argtypes = [i, i]
        lib.ds_flash_smem_bytes.restype = ctypes.c_longlong
        _built = built
    return _built


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _visible(S, causal, window, device):
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    vis = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        vis = kpos <= qpos
        if window is not None:
            vis = vis & (qpos - kpos < int(window))
    return vis, (kpos - qpos).float()


def _scores(q, k, causal, window, slopes, prescale):
    """fp32 scores [B, nkv, g, S, S] with ALiBi and the mask applied.
    ``prescale``: q * scale before the product (the forward) or scale *
    (q . k) after it (the backward), as the TPU kernels place it."""
    B, S, nq, d = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(B, S, nkv, g, d)
    if prescale:
        s = torch.einsum("bskgd,btkd->bkgst", qf * scale, k.float())
    else:
        s = scale * torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    vis, rel = _visible(S, causal, window, q.device)
    if slopes is not None:
        s = s + slopes.float().reshape(nkv, g)[:, :, None, None] * rel
    return torch.where(vis, s, torch.full_like(s, MASK_VALUE))


def flash_attention_reference(q, k, v, causal=True, window=None, slopes=None):
    """(out [B, S, nq, d] in q's dtype, lse [B, nq, S] fp32)."""
    B, S, nq, d = q.shape
    nkv = k.shape[2]
    s = _scores(q, k, causal, window, slopes, prescale=True)
    m = s.amax(dim=-1, keepdim=True)
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    lse = m + torch.log(l.clamp_min(1e-30))
    p = torch.exp(s - lse)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, nq, d).to(q.dtype), lse.reshape(B, nq, S)


def flash_delta(out, dout):
    """delta = rowsum(dO * O) in fp32, [B, nq, S] (the layout of lse)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2)


def flash_attention_reference_bwd(q, k, v, out, lse, dout, causal=True, window=None,
                                  slopes=None, delta=None):
    """(dq, dk, dv) by the flash recurrences on the whole score matrix:
    p = exp(s - lse), delta = rowsum(dO * O) of the stored ``out`` (or the
    ``delta [B, nq, S]`` given), ds = p * (dO . v - delta); GQA sums dk/dv
    over each kv head's group."""
    B, S, nq, d = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, window, slopes, prescale=False)
    p = torch.exp(s - lse.reshape(B, nkv, g, S, 1))
    do = dout.float().reshape(B, S, nkv, g, d)
    if delta is None:
        delta = flash_delta(out, dout)
    delta = delta.float().reshape(B, nkv, g, S, 1)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.float())
    ds = p * (dp - delta)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dk = scale * torch.einsum("bkgst,bskgd->btkd", ds, q.float().reshape(B, S, nkv, g, d))
    dq = scale * torch.einsum("bkgst,btkd->bskgd", ds, k.float())
    return dq.reshape(B, S, nq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, slopes):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, S, n, d] with k and v alike, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, S, nq, d = q.shape
    nkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != d or nq % nkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} (GQA needs nkv | nq)")
    if q.dtype not in (torch.bfloat16, torch.float16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernels take bfloat16 or float16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} unsupported: the kernels are built for 64 and 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device")
    if slopes is not None and (slopes.shape != (nq, ) or slopes.dtype != torch.float32
                               or slopes.device != q.device or not slopes.is_contiguous()):
        raise ValueError(f"slopes must be a contiguous fp32 [nq={nq}] tensor on q's device")
    return B, S, nq, nkv, d


def _contig(*ts):
    out = []
    for t in ts:
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
        out.append(t)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_if(rc: int, name: str) -> None:
    if rc:
        msg = kernel_build().lib.ds_flash_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def _window(causal, window) -> int:
    return int(window) if (causal and window is not None) else 0


def flash_fwd(q, k, v, causal=True, window=None, slopes=None):
    """(out, lse). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, window, slopes)
    B, S, nq, nkv, d = _check(q, k, v, slopes)
    q, k, v = _contig(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, nq, S), dtype=torch.float32, device=q.device)
    rc = kernel_build().lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(slopes), out.data_ptr(), lse.data_ptr(),
        B, S, nq, nkv, d, int(causal), _window(causal, window), int(q.dtype == torch.float16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(rc, "flash_fwd")
    launch_counts["flash_fwd"] += 1
    return out, lse


def _bwd_operands(q, k, v, dout, slopes, **rows):
    """Checks the backward's operands; ``rows`` are the fp32 [B, nq, S]
    tensors by name (lse, and delta for dk/dv). Returns the dims and the
    operands made contiguous: q, k, v, dout, then those of ``rows``."""
    dims = _check(q, k, v, slopes)
    B, S, nq, _, _ = dims
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError("dout must have q's shape and lie on q's CUDA device")
    for name, t in rows.items():
        if t.shape != (B, nq, S) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be fp32 [B, nq, S] = {(B, nq, S)} on q's device")
    return dims, _contig(q, k, v, dout.to(q.dtype), *rows.values())


def flash_bwd_dq(q, k, v, out, lse, dout, causal=True, window=None, slopes=None):
    """(dq in q's dtype, delta = rowsum(dO * O) fp32 [B, nq, S]): the kernel
    writes delta beside dq for :func:`flash_bwd_dkdv`. CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        delta = flash_delta(out, dout)
        dq = flash_attention_reference_bwd(q, k, v, out, lse, dout, causal, window, slopes,
                                           delta)[0]
        return dq, delta
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError("out must have q's shape, dtype and device")
    (B, S, nq, nkv, d), (q, k, v, dout, lse) = _bwd_operands(q, k, v, dout, slopes, lse=lse)
    (out, ) = _contig(out)
    dq = torch.empty_like(q)
    delta = torch.empty((B, nq, S), dtype=torch.float32, device=q.device)
    rc = kernel_build().lib.ds_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), _ptr(slopes), dq.data_ptr(), delta.data_ptr(), B, S, nq, nkv, d,
        int(causal), _window(causal, window), int(q.dtype == torch.float16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(rc, "flash_bwd_dq")
    launch_counts["flash_bwd_dq"] += 1
    return dq, delta


def flash_bwd_dkdv(q, k, v, lse, delta, dout, causal=True, window=None, slopes=None):
    """(dk, dv) in k's dtype from lse and the ``delta`` [B, nq, S] fp32 that
    :func:`flash_bwd_dq` hands back (the output itself is not needed). CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference_bwd(q, k, v, None, lse, dout, causal, window, slopes,
                                             delta)[1:]
    (B, S, nq, nkv, d), (q, k, v, dout, lse, delta) = _bwd_operands(q, k, v, dout, slopes,
                                                                     lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = kernel_build().lib.ds_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(slopes), dk.data_ptr(), dv.data_ptr(), B, S, nq, nkv, d,
        int(causal), _window(causal, window), int(q.dtype == torch.float16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(rc, "flash_bwd_dkdv")
    launch_counts["flash_bwd_dkdv"] += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse); backward runs dq (which writes
    delta) then dk/dv on CUDA tensors, and the plain backward once on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, slopes):
        out, lse = flash_fwd(q, k, v, causal, window, slopes)
        ctx.save_for_backward(q, k, v, out, lse, slopes)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, slopes = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_reference_bwd(q, k, v, out, lse, dout, ctx.causal,
                                                       ctx.window, slopes)
        else:
            dq, delta = flash_bwd_dq(q, k, v, out, lse, dout, ctx.causal, ctx.window, slopes)
            dk, dv = flash_bwd_dkdv(q, k, v, lse, delta, dout, ctx.causal, ctx.window, slopes)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window=None, alibi=False):
    """q: [B, S, nq, d]; k/v: [B, S, nkv, d] with nq % nkv == 0.
    ``window``: query i attends keys in (i - window, i]; needs causal.
    ``alibi``: True adds ``slope_h * (k_pos - q_pos)`` with the standard
    slopes of nq heads; a [nq] fp32 tensor on q's device gives the slopes
    (a tensor-parallel rank's slice of the whole model's, see
    :func:`slope_table`)."""
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal attention")
        window = int(window)
    slopes = alibi if torch.is_tensor(alibi) else (slope_table(q.shape[2], q.device)
                                                    if alibi else None)
    return FlashAttention.apply(q, k, v, causal, window, slopes)


_SLOPES = {}


def slope_table(n_heads: int, device) -> torch.Tensor:
    """The ALiBi slopes on ``device``, copied there once (a host-to-device
    copy per call would synchronise every layer)."""
    key = (n_heads, str(device))
    if key not in _SLOPES:
        from ..models.transformer import alibi_slopes

        _SLOPES[key] = torch.as_tensor(alibi_slopes(n_heads), device=device)
    return _SLOPES[key]
