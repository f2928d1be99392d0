"""Grouped matmul for mixture-of-experts layers, for PyTorch on an NVIDIA
H100.

Counterpart of ``deepspeed_tpu/ops/pallas/grouped_matmul.py``. The
dispatcher (``moe/grouped.py``) sorts the routed tokens by expert and pads
each expert's group to whole row blocks of ``block_t`` rows, so row block
``i`` multiplies exactly one expert's weights, ``rhs[block_expert[i]]``:

- :func:`gmm`: ``[T, K] x [E, K, N] -> [T, N]`` in lhs's dtype, fp32
  accumulation (the forward); ``trans_b=True`` multiplies by
  ``rhs[e]^T`` of an ``[E, N, K]`` rhs read through its strides (the
  backward's dx: no transposed copy of the expert weights is made).
- :func:`tgmm`: ``[T, K] x [T, N] -> [E, K, N]`` fp32, each expert's sum of
  ``lhs_blk^T @ dy_blk`` over its row blocks (the backward's dw).
- :func:`grouped_matmul`: the differentiable product, a
  ``torch.autograd.Function`` mirroring the TPU package's custom VJP
  (``_gm``/``_gm_fwd``/``_gm_bwd``, ``:199-221``): dy is cast to lhs's dtype,
  dx = gmm(dy, rhs, trans_b), dw = tgmm(lhs, dy) cast to rhs's dtype (that
  bf16 rounding of dw is what the reference computes).

:func:`gmm_plain` and :func:`tgmm_plain` are the plain PyTorch versions
(one fp32 product per row block): the CPU path and the numerics oracle.
:func:`gmm` and :func:`tgmm` wrap the hand-written CUDA kernels of
``csrc/grouped_matmul.cu``; on a CPU tensor they return the plain version,
on a CUDA tensor they launch their kernel or raise. The TPU package's
kernel-config registry (``_resolve_gmm_tiles``) is not ported: the kernels
pick their own tiles. On the card ``block_t`` must be a multiple of 128.

Two kernel routes, chosen by :func:`route` from the widths alone (never on
a failure): ``"wgmma"`` (``ds_gmm`` / ``ds_tgmm``: Hopper's warpgroup MMA
fed by TMA, which needs every operand row to start on 16 bytes, so K and N
multiples of 8) and ``"wmma"`` (``ds_gmm_wmma`` / ``ds_tgmm_wmma``: the
first version's ``nvcuda::wmma`` kernels, for any other width).

``launch_counts`` counts kernel launches per kernel and route (``gmm`` and
``tgmm`` the wgmma route, ``gmm_wmma`` and ``tgmm_wmma`` the other);
nothing else adds to it.
"""

import ctypes

import torch

from ._build import build_kernel

launch_counts = {"gmm": 0, "tgmm": 0, "gmm_wmma": 0, "tgmm_wmma": 0}
KERNEL_ROWS = 128  # the kernels' row tile: block_t must be a multiple on the card
MAX_EXPERTS = 65535  # the kernels' expert bound (csrc/grouped_matmul.cu: kMaxExperts)
_SUFFIX = {"wgmma": "", "wmma": "_wmma"}  # route -> suffix of its C entry points and counts

_built = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_build():
    """Build (first call) and return the kernel library (``.lib``,
    ``.seconds`` nvcc's wall time, ``.ptxas`` its report)."""
    global _built
    if _built is None:
        built = build_kernel("grouped_matmul")
        lib = built.lib
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ds_gmm, lib.ds_tgmm, lib.ds_gmm_wmma, lib.ds_tgmm_wmma):
            fn.argtypes = [vp] * 4 + [i] * 6 + [vp]
            fn.restype = i
        lib.ds_gmm_smem_bytes.argtypes = []
        lib.ds_gmm_smem_bytes.restype = i
        lib.ds_gmm_error_string.argtypes = [i]
        lib.ds_gmm_error_string.restype = ctypes.c_char_p
        _built = built
    return _built


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gmm_plain(lhs, rhs, block_expert, block_t=128, trans_b=False):
    """One fp32 product per row block, rounded once to lhs's dtype. Reads
    the block table on the host (the plain version is not the hot path);
    each expert's weights are cast to fp32 once, as the table is sorted."""
    T = lhs.shape[0]
    N = rhs.shape[1] if trans_b else rhs.shape[2]
    out = torch.empty((T, N), dtype=lhs.dtype, device=lhs.device)
    w, cur = None, None
    for i, e in enumerate(block_expert.tolist()):
        if e != cur:
            w = (rhs[e].t() if trans_b else rhs[e]).float()
            cur = e
        rows = slice(i * block_t, (i + 1) * block_t)
        out[rows] = (lhs[rows].float() @ w).to(lhs.dtype)
    return out


def tgmm_plain(lhs, dy, block_expert, num_experts, block_t=128):
    """fp32 ``out[e] += lhs_blk^T @ dy_blk`` over the row blocks; an expert
    with no row block stays zero (as the kernel writes it)."""
    out = torch.zeros((num_experts, lhs.shape[1], dy.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    for i, e in enumerate(block_expert.tolist()):
        rows = slice(i * block_t, (i + 1) * block_t)
        out[e].addmm_(lhs[rows].float().t(), dy[rows].float())
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def route(K: int, N: int) -> str:
    """The kernel route for a product of reduction width / output width
    ``K`` / ``N`` (gmm) or output ``[K, N]`` (tgmm): ``"wgmma"`` when both
    are multiples of 8 (TMA describes only rows that start on 16 bytes),
    else ``"wmma"``."""
    return "wgmma" if K % 8 == 0 and N % 8 == 0 else "wmma"


def _check(name, a, b, block_expert, block_t):
    if a.dim() != 2:
        raise ValueError(f"{name}: lhs must be [T, K], got {tuple(a.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float16) or b.dtype != a.dtype:
        raise ValueError(f"{name}: the kernels take bfloat16 or float16 operands of one dtype, "
                         f"got {a.dtype}/{b.dtype}")
    T = a.shape[0]
    if block_t % KERNEL_ROWS or T % block_t:
        raise ValueError(f"{name}: block_t {block_t} must be a multiple of {KERNEL_ROWS} and "
                         f"divide T = {T}")
    if (block_expert.shape != (T // block_t, ) or block_expert.dtype != torch.int32):
        raise ValueError(f"{name}: block_expert must be int32 [{T // block_t}], got "
                         f"{block_expert.dtype} {tuple(block_expert.shape)}")
    for n, t in (("lhs", a), ("operand", b), ("block_expert", block_expert)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{name}: {n} must lie on lhs's CUDA device")


def _contig(*ts):
    out = []
    for t in ts:
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
        out.append(t)
    return out


def _raise_if(rc: int, name: str) -> None:
    if rc:
        msg = kernel_build().lib.ds_gmm_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def gmm(lhs, rhs, block_expert, block_t=128, trans_b=False):
    """``out[i*bt:(i+1)*bt] = lhs[i*bt:(i+1)*bt] @ rhs[block_expert[i]]``
    (``rhs [E, K, N]``), or ``@ rhs[block_expert[i]]^T`` with ``trans_b``
    (``rhs [E, N, K]``). CPU tensors take the plain version."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, block_expert, block_t, trans_b)
    _check("gmm", lhs, rhs, block_expert, block_t)
    T, K = lhs.shape
    if rhs.dim() != 3 or rhs.shape[2 if trans_b else 1] != K:
        raise ValueError(f"gmm: rhs {tuple(rhs.shape)} does not contract with lhs "
                         f"{tuple(lhs.shape)} (trans_b={trans_b})")
    N = rhs.shape[1] if trans_b else rhs.shape[2]
    if rhs.shape[0] > MAX_EXPERTS:
        raise ValueError(f"gmm: the kernels address at most {MAX_EXPERTS} experts, got "
                         f"{rhs.shape[0]}")
    lhs, rhs, be = _contig(lhs, rhs, block_expert)
    out = torch.empty((T, N), dtype=lhs.dtype, device=lhs.device)
    name = "gmm" + _SUFFIX[route(K, N)]
    rc = getattr(kernel_build().lib, f"ds_{name}")(
        lhs.data_ptr(), rhs.data_ptr(), be.data_ptr(), out.data_ptr(), T, K, N, block_t,
        int(trans_b), int(lhs.dtype == torch.float16),
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _raise_if(rc, name)
    launch_counts[name] += 1
    return out


def tgmm(lhs, dy, block_expert, num_experts, block_t=128):
    """fp32 ``[E, K, N]``: ``out[e] = sum_{i: be[i]=e} lhs_blk_i^T @
    dy_blk_i``. CPU tensors take the plain version."""
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, dy, block_expert, num_experts, block_t)
    _check("tgmm", lhs, dy, block_expert, block_t)
    if dy.dim() != 2 or dy.shape[0] != lhs.shape[0]:
        raise ValueError(f"tgmm: dy {tuple(dy.shape)} must be [T = {lhs.shape[0]}, N]")
    T, K = lhs.shape
    N = dy.shape[1]
    lhs, dy, be = _contig(lhs, dy, block_expert)
    out = torch.empty((num_experts, K, N), dtype=torch.float32, device=lhs.device)
    name = "tgmm" + _SUFFIX[route(K, N)]
    rc = getattr(kernel_build().lib, f"ds_{name}")(
        lhs.data_ptr(), dy.data_ptr(), be.data_ptr(), out.data_ptr(), T, K, N, block_t,
        num_experts, int(lhs.dtype == torch.float16),
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _raise_if(rc, name)
    launch_counts[name] += 1
    return out


class GroupedMatmul(torch.autograd.Function):
    """Forward gmm; backward dx by gmm against the transposed expert
    weights (read through the kernel's strides), dw by tgmm."""

    @staticmethod
    def forward(ctx, lhs, rhs, block_expert, block_t):
        ctx.save_for_backward(lhs, rhs, block_expert)
        ctx.block_t = block_t
        return gmm(lhs, rhs, block_expert, block_t)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, be = ctx.saved_tensors
        bt = ctx.block_t
        dy = dy.to(lhs.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, rhs, be, bt, trans_b=True)
        if ctx.needs_input_grad[1]:
            dw = tgmm(lhs, dy, be, rhs.shape[0], bt).to(rhs.dtype)
        return dx, dw, None, None


def grouped_matmul(lhs, rhs, block_expert, block_t=128):
    """Differentiable grouped matmul ``[T, K] x [E, K, N] -> [T, N]``;
    ``block_expert`` is int32 ``[T // block_t]``, non-decreasing."""
    return GroupedMatmul.apply(lhs, rhs, block_expert, block_t)
