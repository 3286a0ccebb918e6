"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o <source>.o csrc/<source>.cu          (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o build/kernels/<name>.so *.o

The library lands in ``build/kernels/`` at the repository root, named by a hash
of the sources, so an edited source rebuilds. ``ptxas`` register and
shared-memory reports go to ``build/kernels/<name>.log``. A failed build raises
with the compiler's output; nothing falls back.

The library links against the CUDA runtime only: the kernels that load by TMA
(K2, K3 full) encode their tensor maps through ``cuTensorMapEncodeTiled``,
fetched at run time with ``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``), so
no ``-lcuda`` is needed; no CUTLASS or CuTe headers are used.

Each C entry point takes device pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launches. :class:`Kernel` wraps one
entry point, raises on a non-zero status and counts successful launches.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode())
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ctrl_adapter_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    returns the library's path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{out[:-3]}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = f"{stem}.{os.path.basename(src)[:-3]}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, src]
        with open(obj + ".log", "w") as log:
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    report, failed = [], []
    for cmd, obj, proc in jobs:
        proc.wait()
        with open(obj + ".log") as log:
            report.append(" ".join(cmd) + "\n" + log.read())
        os.remove(obj + ".log")
        if proc.returncode != 0:
            failed.append(report[-1])
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, *_ARCH, "-shared", "-o", f"{stem}.tmp", *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        report.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(report[-1])
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(out[:-3] + ".log", "w") as fh:
        fh.write("\n".join(report))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(f"{stem}.tmp", out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.cak_error_string.argtypes = [ctypes.c_int]
        lib.cak_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class Kernel:
    """One C entry point of the kernel library, with a launch counter.

    ``argtypes`` lists the C signature (``ctypes.c_void_p`` for every pointer
    and the stream). ``launches`` counts wrapper calls whose launch returned
    ``cudaSuccess``; nothing else changes it except :meth:`reset`.
    """

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def reset(self) -> None:
        self.launches = 0

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        status = self._fn(*args)
        if status != 0:
            msg = library().cak_error_string(status).decode()
            raise RuntimeError(f"{self.symbol}: CUDA launch failed ({status}: {msg})")
        self.launches += 1


def ptr(t) -> int:
    """A tensor's device address, for a ``ctypes.c_void_p`` argument."""
    return t.data_ptr()


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, for a ``ctypes.c_void_p``
    argument (PyTorch's raw-stream query: no Stream object per launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
