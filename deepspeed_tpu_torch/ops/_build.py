"""Build and load the port's hand-written CUDA kernels.

A ``*.cu`` source under ``ops/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes). The
build runs at first use, never at import, into ``build/torch_kernels/`` at
the root of the checkout; the library's file name carries a hash of its
source, of every header it includes by a quoted path (``csrc/*.cuh``,
followed recursively) and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded.

The host ops (``csrc/adam/cpu_adam.cpp``, ``csrc/aio/deepspeed_aio.cpp``:
ZeRO-Offload's CPU Adam and its NVMe I/O) are C++ for the host, built the
same way by ``g++`` (:func:`build_host_op`) with the JAX package's flags, so
the two packages' host updates agree bit for bit.

A failed build raises: there is no fallback that hides a missing kernel.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-march=native"]


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


class KernelBuildError(RuntimeError):
    pass


def source_key(src: Path) -> str:
    """The build's cache key: a hash of ``src``, of every file it includes
    by a quoted path (resolved beside the including file, recursively) and
    of ``NVCC_FLAGS``."""
    h = hashlib.sha256()
    seen = set()

    def add(path: Path) -> None:
        if path in seen:
            return
        seen.add(path)
        if not path.is_file():
            raise KernelBuildError(f"{path} (included by a kernel source) is missing")
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text + b"\0")
        for inc in _INCLUDE.findall(text):
            add((path.parent / inc.decode()).resolve())

    add(Path(src).resolve())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels are built from source at first "
                           "use and need the CUDA toolkit (PATH or /usr/local/cuda/bin)")


class Built(NamedTuple):
    """One source's library: the loaded handle, its path, the build's wall
    time (0.0 when reused from an earlier build) and nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills per kernel)."""
    lib: ctypes.CDLL
    path: Path
    seconds: float
    ptxas: str


def build_kernel(stem: str) -> Built:
    """Compile (or reuse) and load ``csrc/<stem>.cu``."""
    src = CSRC / f"{stem}.cu"
    out = BUILD_DIR / f"lib{stem}_{source_key(src)}.so"
    log = out.with_suffix(".ptxas.txt")
    if out.exists():
        return Built(ctypes.CDLL(str(out)), out, 0.0, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    report = proc.stdout + proc.stderr
    log.write_text(report)
    return Built(ctypes.CDLL(str(out)), out, dt, report)


_host_lock = threading.Lock()
_host_loaded = {}


def build_host_op(name: str, sources) -> ctypes.CDLL:
    """Compile (or reuse) and load the host library ``name`` from
    ``sources`` (paths under ``csrc/``) with ``g++ GXX_FLAGS``; the file
    name carries a hash of the sources and the flags. Loaded once a
    process."""
    with _host_lock:
        if name in _host_loaded:
            return _host_loaded[name]
        srcs = [CSRC / s for s in sources]
        h = hashlib.sha256()
        for src in srcs:
            if not src.is_file():
                raise KernelBuildError(f"{src} (a host op source) is missing")
            h.update(src.read_bytes())
        h.update(" ".join(GXX_FLAGS).encode())
        out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise KernelBuildError(f"g++ not found: the host op '{name}' is built from "
                                       f"source at first use")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), *map(str, srcs)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(f"g++ failed for the host op '{name}' (exit "
                                       f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _host_loaded[name] = lib
        return lib
