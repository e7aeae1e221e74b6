"""ctypes bridge to the port's readahead pool (``csrc/fileprefetch.cpp``; the
JAX package's ``utils/native.py`` ``FilePrefetcher``).

The library is compiled with ``g++`` on first use into
``build/torch_kernels/`` at the repository root, named by a hash of the
source and of the host's CPU (it is built with ``-march=native``, so a
library that travels to another CPU is rebuilt). Nothing is built when the
module is imported. Without a compiler, ``FilePrefetcher`` issues the same
``posix_fadvise`` from a Python thread pool; ``native`` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fileprefetch.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False
build_log = ""  # the compiler's output of this process's build, or its failure


def _host_build_tag() -> str:
    """Identity of the CPU a ``-march=native`` library was built for."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.lower().startswith("flags")), "")
    except OSError:
        pass
    return hashlib.sha1((platform.machine() + flags).encode()).hexdigest()[:16]


def load_lib() -> ctypes.CDLL | None:
    """Build (once) and load the readahead library; None when it cannot be
    built here (``build_log`` says why)."""
    global _lib, _lib_failed, build_log
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
                                    + _host_build_tag().encode()).hexdigest()[:16]
            path = BUILD_DIR / f"{SOURCE.stem}-{digest}.so"
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                base = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
                proc = subprocess.run([base[0], "-march=native", *base[1:]],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    proc = subprocess.run(base, capture_output=True, text=True, check=True)
                build_log = proc.stdout + proc.stderr
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.fp_create.restype = ctypes.c_void_p
            lib.fp_create.argtypes = [ctypes.c_int]
            lib.fp_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.fp_wait_all.argtypes = [ctypes.c_void_p]
            lib.fp_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            build_log = f"{e!r} {getattr(e, 'stderr', '') or ''}"
            _lib_failed = True
        return _lib


class FilePrefetcher:
    """Warms files into the OS page cache ahead of the loader's reads:
    ``posix_fadvise(WILLNEED)`` from a C++ worker pool (``native`` True), or
    from a Python thread pool where the library cannot be built."""

    def __init__(self, threads: int = 2):
        lib = load_lib()
        self._lib = lib
        self._handle = lib.fp_create(threads) if lib is not None else None
        self._pool = None if lib is not None else ThreadPoolExecutor(max_workers=threads)
        self._futures: list = []
        # Fences prefetch()/wait_all() against close(): the native handle
        # must not be destroyed mid-call.
        self._close_lock = threading.Lock()

    @property
    def native(self) -> bool:
        return self._handle is not None

    def prefetch(self, *paths: str) -> None:
        """Queue ``paths`` for readahead; a no-op after close()."""
        with self._close_lock:
            for p in paths:
                if self._handle is not None:
                    self._lib.fp_prefetch(self._handle, p.encode())
                elif self._pool is not None:
                    self._futures.append(self._pool.submit(self._py_warm, p))

    @staticmethod
    def _py_warm(path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
            finally:
                os.close(fd)
        except (OSError, AttributeError):
            pass  # the loader raises the real error on its own read

    def wait_all(self) -> None:
        with self._close_lock:
            if self._handle is not None:
                self._lib.fp_wait_all(self._handle)
                return
            pending, self._futures = self._futures, []
        for f in pending:
            f.result()

    def close(self) -> None:
        with self._close_lock:
            if self._handle is not None:
                self._lib.fp_destroy(self._handle)
                self._handle = None
            elif self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["BUILD_DIR", "FilePrefetcher", "SOURCE", "load_lib"]
