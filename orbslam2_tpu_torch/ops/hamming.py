"""Hamming distance over packed 256-bit ORB descriptors: the plain PyTorch
version of kernel K1 (`ops/cuda_hamming.py`).

Port of `orbslam2_tpu.ops.hamming`. Descriptors are [*, 8] int32 words
holding the reference package's uint32 bits; each word is widened to
int64 and masked to its 32 bits before the SWAR popcount, so signedness
never reaches the bit arithmetic.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of the low 32 bits of an integer tensor."""
    v = v.to(torch.int64) & _LOW32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & _LOW32) >> 24).to(torch.int32)


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming: a [N, 8], b [M, 8] int32 -> [N, M] int32 (0..256).
    One [N, M] XOR + popcount per word, summed over the 8 words."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for w in range(a.shape[1]):
        out += popcount_u32(torch.bitwise_xor(a[:, w, None], b[None, :, w]))
    return out


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance: a, b [..., 8] int32 (broadcast) ->
    [...] int32."""
    return torch.sum(popcount_u32(torch.bitwise_xor(a, b)), dim=-1, dtype=torch.int32)
