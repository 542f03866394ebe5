"""Build, load and count the port's hand-written CUDA kernels.

The sources in `csrc/` (K1 `hamming.cu`, K2 `pose_gn.cu`) expose a plain C
interface. At first use they are compiled with `nvcc` for Hopper
(``sm_90a``) into one shared library under `_build/`, named by a hash of
the sources, and loaded with `ctypes`. No file includes PyTorch's headers,
so a build takes seconds, not the minutes a
`torch.utils.cpp_extension` build takes.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine may have no `nvcc` at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("hamming.cu", "pose_gn.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

# Kernel launches made by the wrappers (ops/cuda_hamming.py,
# solvers/cuda_pose_opt.py); a wrapper adds one where it launches its
# kernel and nowhere else. Callers reset the counts by assigning 0.
launch_counts = {"hamming": 0, "pose_gn": 0}

# The most observation slots one K2 launch takes (csrc/pose_gn.cu: ten a
# thread, 256 threads); `library()` checks it against the kernel's.
POSE_GN_MAX_SLOTS = 2560

_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc's output (ptxas register/spill report)
build_seconds = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"orbslam2_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library built from the same sources
    and flags exists. Returns the library's path."""
    global build_log, build_seconds
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hamming_distance_matrix.argtypes = [p, p, p, i, i, p]
        lib.hamming_distance_matrix.restype = i
        lib.pose_gn.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p, p, p, p]
        lib.pose_gn.restype = i
        lib.pose_gn_max_slots.argtypes = []
        lib.pose_gn_max_slots.restype = i
        if lib.pose_gn_max_slots() != POSE_GN_MAX_SLOTS:
            raise RuntimeError(f"pose_gn takes {lib.pose_gn_max_slots()} slots, "
                               f"not POSE_GN_MAX_SLOTS = {POSE_GN_MAX_SLOTS}")
        _lib = lib
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (refused launches never run,
    and a later synchronise does not report them)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
