"""Async file I/O for the NVMe tier of ZeRO-Offload.

Counterpart of ``deepspeed_tpu/ops/aio/__init__.py`` (the reference's
``aio_handle``): ``async_pread`` / ``async_pwrite`` submit requests to the
thread pool of ``ops/csrc/aio/deepspeed_aio.cpp``, ``wait()`` blocks until
all are done and raises the first error. Buffers are contiguous CPU
tensors or numpy arrays; the library is built by ``g++`` at first use.
"""

import ctypes

import torch

from .._build import build_host_op

_P = ctypes.c_void_p
_FUNCS = {
    "ds_aio_create": (_P, [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]),
    "ds_aio_submit_read": (ctypes.c_int, [_P, ctypes.c_char_p, _P, ctypes.c_longlong,
                                          ctypes.c_longlong]),
    "ds_aio_submit_write": (ctypes.c_int, [_P, ctypes.c_char_p, _P, ctypes.c_longlong,
                                           ctypes.c_longlong]),
    "ds_aio_wait": (ctypes.c_int, [_P]),
    "ds_aio_pending": (ctypes.c_int, [_P]),
    "ds_aio_destroy": (None, [_P]),
    "ds_aio_sync_pread": (ctypes.c_int, [ctypes.c_char_p, _P, ctypes.c_longlong,
                                         ctypes.c_longlong]),
    "ds_aio_sync_pwrite": (ctypes.c_int, [ctypes.c_char_p, _P, ctypes.c_longlong,
                                          ctypes.c_longlong]),
}


def _lib():
    lib = build_host_op("ds_aio", ["aio/deepspeed_aio.cpp"])
    if not getattr(lib, "_ds_typed", False):
        for fname, (restype, argtypes) in _FUNCS.items():
            f = getattr(lib, fname)
            f.restype = restype
            f.argtypes = argtypes
        lib._ds_typed = True
    return lib


def _buf(buffer):
    """(address, bytes) of a contiguous CPU tensor or numpy array."""
    if torch.is_tensor(buffer):
        if buffer.device.type != "cpu" or not buffer.is_contiguous():
            raise ValueError("aio buffers must be contiguous CPU tensors")
        return buffer.data_ptr(), buffer.numel() * buffer.element_size()
    if not buffer.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous")
    return buffer.ctypes.data, buffer.nbytes


class AsyncIOHandle:
    """Submit reads and writes, then ``wait()``. Every submitted buffer is
    kept alive until the next ``wait()`` returns."""

    def __init__(self, block_size=1 << 20, queue_depth=8, thread_count=None,
                 single_submit=False, overlap_events=True, use_o_direct=False):
        self._lib = _lib()
        self._h = self._lib.ds_aio_create(int(thread_count or queue_depth), int(block_size),
                                          int(bool(use_o_direct)))
        if not self._h:
            raise RuntimeError("failed to create the aio handle")
        self._inflight = []

    def _submit(self, fn, buffer, filename, file_offset, what):
        ptr, nbytes = _buf(buffer)
        rc = fn(self._h, str(filename).encode(), ptr, nbytes, int(file_offset))
        if rc != 0:
            raise OSError(-rc, f"aio {what} submit failed for {filename}")
        self._inflight.append(buffer)

    def async_pread(self, buffer, filename, file_offset: int = 0):
        self._submit(self._lib.ds_aio_submit_read, buffer, filename, file_offset, "read")

    def async_pwrite(self, buffer, filename, file_offset: int = 0):
        self._submit(self._lib.ds_aio_submit_write, buffer, filename, file_offset, "write")

    def wait(self):
        rc = self._lib.ds_aio_wait(self._h)
        self._inflight.clear()
        if rc != 0:
            raise OSError(-rc, "aio request failed")
        return 0

    def pending(self):
        return int(self._lib.ds_aio_pending(self._h))

    def sync_pread(self, buffer, filename, file_offset: int = 0):
        ptr, nbytes = _buf(buffer)
        rc = self._lib.ds_aio_sync_pread(str(filename).encode(), ptr, nbytes, int(file_offset))
        if rc != 0:
            raise OSError(-rc, f"pread failed for {filename}")

    def sync_pwrite(self, buffer, filename, file_offset: int = 0):
        ptr, nbytes = _buf(buffer)
        rc = self._lib.ds_aio_sync_pwrite(str(filename).encode(), ptr, nbytes, int(file_offset))
        if rc != 0:
            raise OSError(-rc, f"pwrite failed for {filename}")

    def close(self):
        if self._h:
            self._lib.ds_aio_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass


__all__ = ["AsyncIOHandle"]
