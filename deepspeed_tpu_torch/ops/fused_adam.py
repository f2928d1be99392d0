"""Fused, gated AdamW as one multi-tensor pass, for PyTorch on an NVIDIA
H100.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_adam.py``: one kernel reads
(grad, param, m, v) and writes (param, m, v), 28 bytes per fp32 element,
with the loss un-scaling and the clip coefficient folded into
``grad_scale`` and the overflow skip into ``gate`` (<= 0 leaves every
tensor untouched).

- :func:`fused_adam_reference` is the plain PyTorch version (the same
  formulas, one torch op each): the CPU path and the numerics oracle.
- :func:`fused_adam_apply` updates in place through the hand-written CUDA
  kernel of ``csrc/fused_adam.cu`` on CUDA tensors (one launch over every
  leaf, whatever their sizes) and through the plain version on CPU tensors.

The per-step scalars ``lr_t``, ``1 - b1^t``, ``1 - b2^t``, ``grad_scale`` and
``gate`` may be device tensors and stay on the device: the kernel reads
them from a device array.

``launch_counts["fused_adam"]`` counts kernel launches; nothing else adds
to it.
"""

import ctypes

import numpy as np
import torch

from ._build import build_kernel

launch_counts = {"fused_adam": 0}

_built = None
_tables = {}  # (device, pointers, sizes, dtypes) -> device table (kept for reuse)


def reset_launch_counts() -> None:
    launch_counts["fused_adam"] = 0


def kernel_build():
    global _built
    if _built is None:
        built = build_kernel("fused_adam")
        lib = built.lib
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ds_fused_adam.argtypes = [vp, i, ctypes.c_longlong, vp] + [f] * 6 + [vp]
        lib.ds_fused_adam.restype = i
        lib.ds_fused_adam_chunk.argtypes = []
        lib.ds_fused_adam_chunk.restype = ctypes.c_longlong
        lib.ds_fused_adam_error_string.argtypes = [i]
        lib.ds_fused_adam_error_string.restype = ctypes.c_char_p
        _built = built
    return _built


def _scalar(x, device) -> torch.Tensor:
    """fp32 0-dim tensor on ``device``; a Python number is filled there by a
    kernel (no host-to-device copy, so no synchronisation)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def bias_corrections(b1: float, b2: float, step, device):
    """(1 - b1^t, 1 - b2^t) in fp32 for the 1-based update index ``step``."""
    t = _scalar(step, device)
    return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


def one_minus(b: float) -> float:
    """``1 - b`` as the TPU kernel computes it from its fp32 scalar (an fp32
    subtraction: 1 - 0.999 is 0.00099998713 there, not fp32(0.001))."""
    return float(np.float32(1.0) - np.float32(b))


def fused_adam_reference(params, mu, nu, grads, *, lr_t, b1, b2, eps, weight_decay, step,
                         grad_scale, gate):
    """Plain version of :func:`fused_adam_apply` (updates in place)."""
    dev = params[0].device
    bc1, bc2 = bias_corrections(b1, b2, step, dev)
    lr = _scalar(lr_t, dev)
    gs = _scalar(grad_scale, dev)
    ok = _scalar(gate, dev) > 0
    omb1, omb2 = one_minus(b1), one_minus(b2)
    with torch.no_grad():
        for p, m, v, g in zip(params, mu, nu, grads):
            g = g.float() * gs
            m_new = b1 * m + omb1 * g
            v_new = b2 * v + omb2 * g * g
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + weight_decay * p
            p.copy_(torch.where(ok, p - lr * upd, p))
            m.copy_(torch.where(ok, m_new, m))
            v.copy_(torch.where(ok, v_new, v))


def _table(params, mu, nu, grads, chunk):
    key = (params[0].device, ) + tuple(
        (p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), p.numel(), g.dtype)
        for p, m, v, g in zip(params, mu, nu, grads))
    hit = _tables.get(key)
    if hit is not None:
        return hit
    rows, c0 = [], 0
    for p, m, v, g in zip(params, mu, nu, grads):
        ptrs = (p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr())
        vec = all(x % 16 == 0 for x in ptrs[:3]) and g.data_ptr() % (16 if g.dtype ==
                                                                      torch.float32 else 8) == 0
        rows.append((*ptrs, p.numel(), c0, int(g.dtype == torch.bfloat16), int(vec)))
        c0 += -(-p.numel() // chunk)
    host = torch.from_numpy(np.asarray(rows, dtype=np.int64)).pin_memory()
    dev_tab = host.to(params[0].device, non_blocking=True)
    if len(_tables) > 8:  # tensors moved: drop old tables
        _tables.clear()
    _tables[key] = (dev_tab, len(rows), c0, host)
    return _tables[key]


def fused_adam_apply(params, mu, nu, grads, *, lr_t, b1, b2, eps, weight_decay, step,
                     grad_scale, gate):
    """One gated AdamW step over the sequences ``params``/``mu``/``nu`` (fp32,
    updated in place) with ``grads`` (fp32 or bf16). ``step``: the 1-based
    update index for the bias corrections. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    params, mu, nu, grads = list(params), list(mu), list(nu), list(grads)
    if not (len(params) == len(mu) == len(nu) == len(grads)) or not params:
        raise ValueError("params, mu, nu and grads must be non-empty and of one length")
    dev = params[0].device
    if dev.type == "cpu":
        return fused_adam_reference(params, mu, nu, grads, lr_t=lr_t, b1=b1, b2=b2, eps=eps,
                                    weight_decay=weight_decay, step=step,
                                    grad_scale=grad_scale, gate=gate)
    for p, m, v, g in zip(params, mu, nu, grads):
        for name, t in (("param", p), ("mu", m), ("nu", v)):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
                raise ValueError(f"{name} tensors must be contiguous fp32 on {dev}")
        if g.dtype not in (torch.float32, torch.bfloat16) or not g.is_contiguous() \
                or g.device != dev or g.numel() != p.numel() or m.numel() != p.numel() \
                or v.numel() != p.numel():
            raise ValueError("grads must be contiguous fp32/bf16 tensors of their param's size")
    lib = kernel_build().lib
    tab, n, n_chunks, _ = _table(params, mu, nu, grads, lib.ds_fused_adam_chunk())
    bc1, bc2 = bias_corrections(b1, b2, step, dev)
    scal = torch.stack([_scalar(lr_t, dev), bc1, bc2, _scalar(grad_scale, dev),
                        _scalar(gate, dev)])
    rc = lib.ds_fused_adam(tab.data_ptr(), n, n_chunks, scal.data_ptr(), b1, one_minus(b1), b2,
                           one_minus(b2), eps, weight_decay,
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        msg = lib.ds_fused_adam_error_string(rc).decode()
        raise RuntimeError(f"fused_adam kernel launch failed: {msg} (cudaError {rc})")
    launch_counts["fused_adam"] += 1
