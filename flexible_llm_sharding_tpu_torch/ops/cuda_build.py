"""Build and load the port's hand-written CUDA kernels.

``csrc/flash_attention.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``. The library lands in ``build/torch_kernels/`` at the
repository root, named by a hash of the source and flags, so an edited
source rebuilds and an unchanged one loads as is. Nothing is built when this
module is imported: the first call to :func:`library` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "flash_attention.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SOURCE_ARGS = [_P, _P, _LL, _LL, _I, _P, _I, _I, _I, _I]
_SIGNATURES = {
    "fls_score_attention": [_I, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I]
    + _SOURCE_ARGS + _SOURCE_ARGS + [_P],
    "fls_decode_attention": [_I, _I, _P, _P, _I, _I, _I, _I, _F, _F,
                             _P, _P, _LL, _I, _P,
                             _P, _P, _LL, _LL, _I, _P,
                             _P, _P, _LL, _LL, _I, _I,
                             _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use on a machine with the CUDA toolkit")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use if its hashed ``.so``
    is missing, with ``argtypes``/``restype`` declared for every entry point
    (a pointer passed without ``c_void_p`` would be cut to 32 bits). Raises
    with the compiler's output when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            path = BUILD_DIR / f"{SOURCE.stem}-{digest}.so"
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"CUDA kernel build failed:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
        return _lib


__all__ = ["BUILD_DIR", "SOURCE", "library"]
