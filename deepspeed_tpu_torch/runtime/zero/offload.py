"""ZeRO-Offload and ZeRO-Infinity's optimizer tier: Adam on the host.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py:50-343`` over a list
of tensors (the engine's trainable parameters) rather than a pytree. The
card runs the forward and backward and keeps the parameters and their
gradients; the host keeps the fp32 masters (pinned when the parameters are
on a card) and both Adam moments, in RAM or, through
:class:`~deepspeed_tpu_torch.runtime.swap_tensor.OptimizerStateSwapper`, on
NVMe; the C++ kernel of ``ops/csrc/adam/cpu_adam.cpp`` updates each tensor's
masters and moments in place, and the new masters go back up into the
parameters.

On a card the gradients come down through a ring of ``buffer_count``
pinned buffers, each as large as the largest tensor: the copy of tensor
i+1 (on a side stream) overlaps the host update of tensor i, and tensor
i's upload (a ``non_blocking`` copy from the pinned masters, on another
stream) overlaps the update of tensor i+1. The host never holds a second
full copy of the gradients.

:func:`partition_leaves_by_ratio` is the twin-flow split (the reference's
``offload_optimizer.ratio``): the host takes whole tensors, largest first,
up to ``ratio`` of the bytes; the engine updates the rest on the card.

Not ported: the JAX package's ``shard_mode`` (each host holding only its
addressable shards, for world size >= 2); the engine refuses offload there.
"""

import ctypes
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..swap_tensor.optimizer_utils import OptimizerStateSwapper


def partition_leaves_by_ratio(leaves, ratio: float) -> List[bool]:
    """[True where the leaf's optimizer state goes to the host] for
    ``leaves`` (tensors, or byte counts), the JAX function's greedy
    subset sum: largest first, skipping a leaf that would overshoot
    ``ratio`` of the total bytes, then the smallest remaining leaf if
    that lands closer to the target than stopping short (or if the host
    set would otherwise be empty)."""
    sizes = [int(x) if not torch.is_tensor(x) else x.numel() * x.element_size() for x in leaves]
    target = ratio * float(sum(sizes))
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    host, acc = set(), 0.0
    for i in order:
        if acc + sizes[i] <= target:
            host.add(i)
            acc += sizes[i]
    if acc < target and len(host) < len(sizes):
        j = min((i for i in range(len(sizes)) if i not in host), key=lambda i: sizes[i])
        if not host or abs((acc + sizes[j]) - target) < abs(acc - target):
            host.add(j)
    return [i in host for i in range(len(sizes))]


_CUDART = None


def _cudart():
    """The CUDA runtime torch loaded (found by its soname), typed for
    ``cudaHostAlloc`` / ``cudaFreeHost``."""
    global _CUDART
    if _CUDART is None:
        for name in ("libcudart.so.12", "libcudart.so"):
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        else:
            raise RuntimeError("the CUDA runtime (libcudart) is not loadable: pinned host "
                               "memory for the offloaded optimizer needs it")
        lib.cudaHostAlloc.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
                                      ctypes.c_uint]
        lib.cudaHostAlloc.restype = ctypes.c_int
        lib.cudaFreeHost.argtypes = [ctypes.c_void_p]
        lib.cudaFreeHost.restype = ctypes.c_int
        _CUDART = lib
    return _CUDART


def _host_buffer(n: int, pinned: bool = False) -> torch.Tensor:
    """n fp32 host elements. Unpinned: numpy's calloc, zero pages until
    first written. ``pinned``: page-locked for the card's async copies by
    ``cudaHostAlloc`` (portable), exactly n elements, freed by
    :func:`_release` (the caching host allocator would round a block up
    to a power of two and keep it after it is freed; registering calloc'd
    memory with ``cudaHostRegister`` took ~3x as long on an H100 host)."""
    if not pinned or not n:
        return torch.from_numpy(np.zeros(n, np.float32))
    ptr = ctypes.c_void_p()
    rc = _cudart().cudaHostAlloc(ctypes.byref(ptr), 4 * n, 1)  # cudaHostAllocPortable
    if rc != 0 or not ptr.value:
        raise RuntimeError(f"cudaHostAlloc of {4 * n} bytes failed (error {rc})")
    return torch.frombuffer((ctypes.c_float * n).from_address(ptr.value), dtype=torch.float32)


def _release(t: torch.Tensor, pinned: bool) -> None:
    """Free a pinned :func:`_host_buffer` (no view of it may be used after)."""
    if pinned and t.numel():
        _cudart().cudaFreeHost(ctypes.c_void_p(t.data_ptr()))


class HostOffloadOptimizer:
    """fp32 masters and Adam moments on the host, the fused C++ update a
    tensor at a time, the new masters uploaded into ``params``.

    ``params``: the tensors it updates (the engine's trainable parameters,
    or the twin-flow host subset), on a card or on the CPU; the masters are
    copies, never aliases. ``keys``: a name per tensor (the NVMe files'
    names; default its index). ``nvme_path``: moments on the disk there.
    """

    def __init__(self, params: Sequence[torch.Tensor], lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, adamw_mode: bool = True,
                 nvme_path: Optional[str] = None, pipeline_read: bool = True,
                 pipeline_write: bool = True, grad_clip: float = 0.0,
                 keys: Optional[Sequence[str]] = None, buffer_count: int = 4):
        from ...ops.adam.cpu_adam import DeepSpeedCPUAdam

        self.opt = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                    adamw_mode=adamw_mode)
        self.grad_clip = grad_clip
        self.params = list(params)
        if not self.params:
            raise ValueError("the host optimizer needs at least one tensor")
        self.keys = list(keys) if keys is not None else [str(i) for i in range(len(self.params))]
        self.device = self.params[0].device
        self._pinned = self.device.type == "cuda"
        sizes = [p.numel() for p in self.params]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        t0 = time.perf_counter()
        # one flat buffer of masters, a view a tensor (copies of the params)
        self._flat = _host_buffer(self._offsets[-1], self._pinned)
        t1 = time.perf_counter()
        self.masters: Dict[str, torch.Tensor] = {}
        for i, (key, p) in enumerate(zip(self.keys, self.params)):
            view = self._flat[self._offsets[i]:self._offsets[i + 1]]
            view.copy_(p.detach().reshape(-1).float())
            self.masters[key] = view
        self.shapes = {key: tuple(p.shape) for key, p in zip(self.keys, self.params)}
        t2 = time.perf_counter()

        self.swapper = None
        self.moments: Dict[str, Dict[str, torch.Tensor]] = {}
        if nvme_path:
            self.swapper = OptimizerStateSwapper(nvme_path, pipeline_read=pipeline_read,
                                                 pipeline_write=pipeline_write)
            for key in self.keys:
                self.swapper.initialize(key, self.masters[key].shape)
            self.swapper.flush_writes()
        else:
            for key in self.keys:  # zero pages until the first step's kernel writes them
                n = self.masters[key].numel()
                self.moments[key] = {"exp_avg": _host_buffer(n), "exp_avg_sq": _host_buffer(n)}

        self._ring = None
        if self._pinned:
            self._nbuf = max(2, int(buffer_count))
            self._slot = max(sizes)
            self._ring = _host_buffer(self._nbuf * self._slot, True)
            self._copy_stream = torch.cuda.Stream(self.device)
            self._upload_stream = torch.cuda.Stream(self.device)
        self.times: Dict[str, float] = {}
        self.init_times = {"masters_alloc_ms": 1e3 * (t1 - t0), "masters_copy_ms": 1e3 * (t2 - t1),
                           "moments_ms": 1e3 * (time.perf_counter() - t2)}

    # ------------------------------------------------------------------
    def _host_norm(self, grads, inv_scale: float) -> float:
        """The global norm of the un-scaled gradients: float64 dots on the
        host, as the JAX function computes it; on the card's own norm for
        card tensors."""
        if grads[0].device.type != "cpu":
            from ..utils import global_norm

            return float(global_norm(grads)) * inv_scale
        sq = 0.0
        for g in grads:
            g64 = g.detach().reshape(-1).float().numpy().astype(np.float64, copy=False)
            sq += float(np.dot(g64, g64))
        return float(np.sqrt(sq)) * inv_scale

    def step(self, step_no: int, grads: Sequence[torch.Tensor], lr: Optional[float] = None,
             loss_scale: float = 1.0, grad_norm: Optional[float] = None, grads_ready=None):
        """One Adam step of every tensor: ``grads`` (one a tensor, loss-scaled
        by ``loss_scale``), ``grad_norm`` their un-scaled global norm (None:
        computed here). A non-finite norm skips the update; the clip folds
        into the kernel's gradient scale. The masters are updated in place
        and uploaded into the parameters. ``grads_ready``: a CUDA event after
        which the gradients are complete (default: the current stream's
        work so far). Returns (norm, overflow)."""
        inv_scale = 1.0 / float(loss_scale)
        norm = self._host_norm(grads, inv_scale) if grad_norm is None else float(grad_norm)
        self.times = {"d2h_wait_ms": 0.0, "host_adam_ms": 0.0, "swap_ms": 0.0,
                      "upload_ms": 0.0}
        if not np.isfinite(norm):
            return norm, True
        scale = inv_scale
        if self.grad_clip and norm > self.grad_clip:
            scale *= self.grad_clip / (norm + 1e-6)
        grads = list(grads)
        if self._ring is None:
            fetch = lambda i: grads[i].detach().reshape(-1).float().contiguous()  # noqa: E731
        else:
            fetch = self._ring_fetch(grads, grads_ready)
        if self.swapper is not None:
            self.swapper.prefetch(self.keys[0])
        for i, key in enumerate(self.keys):
            g = fetch(i)
            if self.swapper is not None:
                t0 = time.perf_counter()
                state = self.swapper.fetch(key)
                if i + 1 < len(self.keys):
                    self.swapper.prefetch(self.keys[i + 1])
                self.times["swap_ms"] += 1e3 * (time.perf_counter() - t0)
            else:
                state = self.moments[key]
            t0 = time.perf_counter()
            self.opt.step(step_no, self.masters[key], g, state["exp_avg"].reshape(-1),
                          state["exp_avg_sq"].reshape(-1), lr=lr, grad_scale=scale)
            self.times["host_adam_ms"] += 1e3 * (time.perf_counter() - t0)
            if self.swapper is not None:
                t0 = time.perf_counter()
                self.swapper.writeback(key, state, async_op=True)
                self.times["swap_ms"] += 1e3 * (time.perf_counter() - t0)
            self._upload(i)
        t0 = time.perf_counter()
        if self.swapper is not None:
            self.swapper.flush_writes()
        self.times["swap_ms"] += 1e3 * (time.perf_counter() - t0)
        self._finish_uploads()
        return norm, False

    def _ring_fetch(self, grads, ready):
        """fetch(i) -> tensor i's gradient in a pinned ring slot, its copy
        issued ``nbuf`` tensors ahead on the copy stream, after ``ready``."""
        copy, nbuf, events = self._copy_stream, self._nbuf, {}
        if ready is not None:
            copy.wait_event(ready)
        else:
            copy.wait_stream(torch.cuda.current_stream(self.device))

        def issue(j):
            n = grads[j].numel()
            slot = self._ring[(j % nbuf) * self._slot:(j % nbuf) * self._slot + n]
            with torch.cuda.stream(copy):
                slot.copy_(grads[j].detach().reshape(-1), non_blocking=True)
                events[j] = (torch.cuda.Event(), slot)
                events[j][0].record(copy)

        for j in range(min(nbuf, len(grads))):
            issue(j)

        def fetch(i):
            if i > 0 and i - 1 + nbuf < len(grads):
                issue(i - 1 + nbuf)  # tensor i-1's slot is free: the host is done with it
            ev, slot = events.pop(i)
            t0 = time.perf_counter()
            ev.synchronize()
            self.times["d2h_wait_ms"] += 1e3 * (time.perf_counter() - t0)
            return slot

        return fetch

    def _upload(self, i: int) -> None:
        """Tensor i's new masters into its parameter."""
        p, master = self.params[i], self.masters[self.keys[i]]
        if self._ring is None:
            p.data.copy_(master.view(p.shape))
            return
        with torch.cuda.stream(self._upload_stream):
            p.data.copy_(master.view(p.shape), non_blocking=True)

    def _finish_uploads(self) -> None:
        """Wait for the uploads (the next step's updates rewrite the
        masters they read); the compute stream waits for them too."""
        if self._ring is None:
            return
        t0 = time.perf_counter()
        self._upload_stream.synchronize()
        torch.cuda.current_stream(self.device).wait_stream(self._upload_stream)
        self.times["upload_ms"] += 1e3 * (time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def rebuild_params(self) -> List[torch.Tensor]:
        """Copies of the masters, shaped as the parameters."""
        return [self.masters[key].view(self.shapes[key]).clone() for key in self.keys]

    def state_dict(self):
        """Copies of the masters and moments, by key."""
        moments = self.swapper.state_dict() if self.swapper is not None else self.moments
        return {
            "masters": {k: v.clone() for k, v in self.masters.items()},
            "exp_avg": {k: moments[k]["exp_avg"].reshape(-1).clone() for k in self.keys},
            "exp_avg_sq": {k: moments[k]["exp_avg_sq"].reshape(-1).clone() for k in self.keys},
        }

    def load_state_dict(self, state):
        for key in self.keys:
            self.masters[key].copy_(torch.as_tensor(state["masters"][key]).reshape(-1))
        moments = {k: {name: torch.as_tensor(state[name][k], dtype=torch.float32)
                       .reshape(-1).clone() for name in ("exp_avg", "exp_avg_sq")}
                   for k in self.keys}
        if self.swapper is not None:
            self.swapper.load_state_dict(moments)
        else:
            self.moments = moments

    def host_bytes(self) -> Dict[str, int]:
        """Host bytes held: masters, moments (0 when on the disk), ring."""
        return {"masters": 4 * self._flat.numel(),
                "moments": sum(8 * m.numel() for m in self.masters.values())
                if self.swapper is None else 0,
                "ring": 0 if self._ring is None else 4 * self._ring.numel()}

    def close(self) -> None:
        """Release the pinned host memory."""
        if self._ring is not None:
            torch.cuda.synchronize(self.device)
        for name in ("_flat", "_ring"):
            t = getattr(self, name, None)
            if t is not None:
                _release(t, self._pinned)
                setattr(self, name, None)
        self.masters = {}

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass
