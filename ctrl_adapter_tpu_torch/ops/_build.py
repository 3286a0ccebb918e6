"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and bind them with ``ctypes``.

All ``csrc/*.cu`` files compile in one ``nvcc`` call into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>.so csrc/*.cu

The library lands in ``build/kernels/`` at the repository root, named by a hash
of the sources, so an edited source rebuilds. ``ptxas`` register and
shared-memory reports go to ``build/kernels/<name>.log``. A failed build raises
with the compiler's output; nothing falls back.

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    with open(out[:-3] + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
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


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
