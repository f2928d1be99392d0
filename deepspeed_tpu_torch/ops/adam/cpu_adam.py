"""DeepSpeedCPUAdam: the host's fused Adam over fp32 masters.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py`` (the reference's
``deepspeed/ops/adam/cpu_adam.py``): the ZeRO-Offload optimizer. ``step``
runs the multithreaded C++ kernel of ``ops/csrc/adam/cpu_adam.cpp`` on one
flat range in place; the tensors are contiguous fp32 CPU tensors, pinned
or not, passed by ``data_ptr()``. The library is built by ``g++`` at first
use (``ops/_build.py::build_host_op``), never at import.
"""

import ctypes
import itertools

import torch

from .._build import build_host_op

_ids = itertools.count()
_F = ctypes.c_void_p


def _lib():
    lib = build_host_op("ds_cpu_adam", ["adam/cpu_adam.cpp"])
    if not getattr(lib, "_ds_typed", False):
        lib.ds_adam_create.restype = ctypes.c_int
        lib.ds_adam_create.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                       ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                       ctypes.c_int]
        lib.ds_adam_destroy.restype = ctypes.c_int
        lib.ds_adam_destroy.argtypes = [ctypes.c_int]
        lib.ds_adam_step.restype = ctypes.c_int
        lib.ds_adam_step.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, _F, _F,
                                     _F, _F, ctypes.c_float, ctypes.c_float, _F, ctypes.c_int]
        lib.ds_fp32_to_bf16.restype = None
        lib.ds_fp32_to_bf16.argtypes = [_F, _F, ctypes.c_longlong]
        lib._ds_typed = True
    return lib


def _check(t: torch.Tensor, n: int, dtype=torch.float32):
    if not (t.device.type == "cpu" and t.dtype == dtype and t.is_contiguous() and t.numel() == n):
        raise ValueError(f"the host Adam takes contiguous {dtype} CPU tensors of {n} elements; "
                         f"got {t.dtype} on {t.device}, shape {tuple(t.shape)}, contiguous "
                         f"{t.is_contiguous()}")
    return t.data_ptr()


class DeepSpeedCPUAdam:
    """Fused host Adam / AdamW (the reference's ``DeepSpeedCPUAdam``).

    Construct once, then per tensor ``step(step_no, params, grads, exp_avg,
    exp_avg_sq, lr=, grad_scale=, bf16_out=)``: ``params`` and both moments
    are updated in place (``grads`` are read, times ``grad_scale``);
    ``step_no`` is 1-based (the bias correction); ``lr`` None keeps the
    constructor's. ``bf16_out`` (a bfloat16 tensor of as many elements)
    also receives the new parameters rounded to bf16 in the same pass.
    """

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adamw_mode=True, n_threads=0):
        self._lib = _lib()
        self.opt_id = next(_ids)
        self.defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                             adamw_mode=adamw_mode)
        self.n_threads = n_threads
        rc = self._lib.ds_adam_create(self.opt_id, float(lr), float(betas[0]), float(betas[1]),
                                      float(eps), float(weight_decay), int(bool(adamw_mode)))
        if rc != 0:
            raise RuntimeError(f"ds_adam_create failed rc={rc}")

    def step(self, step_no, params, grads, exp_avg, exp_avg_sq, lr=None, grad_scale=1.0,
             bf16_out=None):
        n = params.numel()
        ptrs = [_check(t, n) for t in (params, grads, exp_avg, exp_avg_sq)]
        out = None if bf16_out is None else _check(bf16_out, n, torch.bfloat16)
        rc = self._lib.ds_adam_step(self.opt_id, int(step_no), n, *ptrs,
                                    float(lr) if lr is not None else -1.0, float(grad_scale), out,
                                    int(self.n_threads))
        if rc != 0:
            raise RuntimeError(f"ds_adam_step failed rc={rc}")

    def fp32_to_bf16(self, src: torch.Tensor, dst: torch.Tensor):
        n = src.numel()
        self._lib.ds_fp32_to_bf16(_check(src, n), _check(dst, n, torch.bfloat16), n)

    def destroy(self):
        if getattr(self, "opt_id", None) is not None:
            self._lib.ds_adam_destroy(self.opt_id)
            self.opt_id = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass
