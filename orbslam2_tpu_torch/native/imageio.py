"""ctypes bindings for the native image decoder and prefetcher
(`image_io.cc`, a byte copy of the reference's).

At first use the source is compiled with `g++` into one shared library
under the package's `_build/` directory, named by a hash of the source
(never into the source tree), and loaded. Nothing runs at import. When the
build or the load fails, `native_available()` is false, `build_error()`
gives the reason, and `decode_image` returns None so that the caller
decodes with PIL, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "image_io.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lib = None
_error: Optional[str] = None
_lock = threading.Lock()


def _lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liborbslam_io_{digest}.so"


def _build(path: Path) -> None:
    """Compile into a temporary file and rename it into place, so that
    processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", str(SRC),
                        "-lz", "-o", tmp], check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        path = _lib_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except subprocess.CalledProcessError as e:
            _error = f"g++ failed: {e.stderr.strip()[-2000:]}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.orbio_decode.restype = ctypes.POINTER(ctypes.c_float)
        lib.orbio_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
        ]
        lib.orbio_free.restype = None
        lib.orbio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.orbio_prefetcher_create.restype = ctypes.c_void_p
        lib.orbio_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int
        ]
        lib.orbio_prefetcher_get.restype = ctypes.POINTER(ctypes.c_float)
        lib.orbio_prefetcher_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.orbio_prefetcher_destroy.restype = None
        lib.orbio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native library could not be built or loaded (None when it
    was, or before the first use)."""
    _load()
    return _error


def _take(lib, ptr, w, h) -> Optional[np.ndarray]:
    if not ptr:
        return None
    n = w.value * h.value
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy().reshape(h.value, w.value)
    lib.orbio_free(ptr)
    return arr


def decode_image(path: str) -> Optional[np.ndarray]:
    """Decode PNG/PGM/PPM to grayscale float32 (16-bit PNGs keep raw counts).
    Returns None and lets callers fall back to PIL when unavailable."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    ptr = lib.orbio_decode(path.encode(), ctypes.byref(w), ctypes.byref(h))
    return _take(lib, ptr, w, h)


class Prefetcher:
    """Threaded read-ahead over a fixed list of image paths.

    Usage:
        pf = Prefetcher(paths, n_threads=3)
        for i in range(len(paths)):
            img = pf.get(i)     # blocks only if IO is behind
        pf.close()
    """

    def __init__(self, paths: Sequence[str], n_threads: int = 2, max_ahead: int = 8):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError(f"native image IO unavailable: {_error}")
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.orbio_prefetcher_create(
            arr, len(self._paths), n_threads, max_ahead
        )
        self._n = len(paths)

    def get(self, idx: int) -> Optional[np.ndarray]:
        if not (0 <= idx < self._n):
            raise IndexError(idx)
        w = ctypes.c_int()
        h = ctypes.c_int()
        ptr = self._lib.orbio_prefetcher_get(
            self._handle, idx, ctypes.byref(w), ctypes.byref(h)
        )
        return _take(self._lib, ptr, w, h)

    def close(self):
        if self._handle:
            self._lib.orbio_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
