"""K1: all-pairs Hamming distance as a hand-written CUDA kernel
(`csrc/hamming.cu`), replacing the Pallas kernel of
`orbslam2_tpu.ops.pallas_hamming`.

`distance_matrix` takes the plain version (`ops/hamming.py`) for tensors
on the CPU and the kernel for tensors on a CUDA device; nothing else
chooses between them.
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.ops import hamming


def launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """One K1 launch on the current stream into a preallocated [N, M]
    int32 `out`, N and M >= 1; no checks, no allocation. The wrapper below
    is the checked entry point; this is also what a timing loop captures."""
    n, m = a.shape[0], b.shape[0]
    err = kernels.library().hamming_distance_matrix(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, kernels.stream_handle(a.device)
    )
    kernels.check_launch("hamming", err)
    kernels.launch_counts["hamming"] += 1


def distance_matrix_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming on the card: a [N, 8], b [M, 8] int32 (uint32
    bits) -> [N, M] int32."""
    kernels.require_cuda("hamming", a, b)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"hamming: expected int32 descriptors, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != 8 or b.shape[1] != 8:
        raise ValueError(f"hamming: expected [N, 8] and [M, 8], got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("hamming: inputs on different devices")
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    if out.numel():
        launch(a, b, out)
    return out


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dispatch on where the tensors lie: the kernel on a CUDA device, the
    plain version on the CPU."""
    if a.device.type == "cpu":
        return hamming.distance_matrix(a, b)
    return distance_matrix_cuda(a, b)
