"""The card's peaks and the least time each hand-written kernel could take
at a launch's shapes (the arithmetic of the program's chip smoke, frozen
here): the larger of the bytes over the memory bandwidth (each input read
once, each output written once) and the operations over the peak of
their type. Published figures of one NVIDIA H100 SXM at 700 W, dense.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12   # HBM3
PEAK_INT8_OPS = 1979e12      # dense int8 tensor cores
PEAK_FP32_FLOPS = 67e12      # float32 outside the tensor cores
# K2: one observation's residual, Jacobian and 27 sums, per iteration
K2_FLOPS_PER_EDGE = 200


def k1_bound_s(n: int, m: int) -> float:
    """K1, the Hamming distance matrix of [n, 8] and [m, 8] uint32
    descriptors into [n, m] int32: 256 XOR-popcounts a pair, counted as
    the int8 products the kernel runs them as (2 x 256 operations a pair)."""
    n_bytes = 32 * (n + m) + 4 * n * m
    return max(n_bytes / PEAK_BYTES_PER_S, 2 * 256 * n * m / PEAK_INT8_OPS)


def k2_bound_s(n: int, edges: int, rounds: int, iters: int) -> float:
    """K2, the robust pose Gauss-Newton over `n` observation slots of which
    `edges` are real: each slot's 29 input bytes read once and its inlier
    flag and chi2 written once; every real observation in every
    iteration."""
    return max((29 * n + 5 * n) / PEAK_BYTES_PER_S,
               K2_FLOPS_PER_EDGE * edges * rounds * iters / PEAK_FP32_FLOPS)
