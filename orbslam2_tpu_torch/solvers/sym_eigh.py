"""Batched symmetric eigendecomposition by cyclic Jacobi rotations.

EPnP and Horn's method need the eigenvectors of small symmetric matrices
(3x3, 4x4, 12x12) for every RANSAC hypothesis at once. `torch.linalg.eigh`
reads its status back to the host on the card (it raises on failure),
which would stall the device queue once per solve; these rotations read
nothing back. Each sweep visits every pair (p, q) once, in the round-robin
order that rotates n/2 disjoint pairs together (one batched matmul per
round), with the classic small-angle rotation (Golub and Van Loan,
Algorithm 8.5.1). A fixed number of sweeps replaces the convergence test.
"""

from __future__ import annotations

import torch


def _round_robin(m: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[m-1, m/2] index pairs (p, q): every pair of 0..m-1 exactly once,
    the pairs of a round disjoint (the circle method). Built on the device
    from `arange`, so no index list is copied from the host."""
    r = torch.arange(m - 1, device=device)[:, None]
    k = torch.arange(1, m // 2, device=device)[None, :]
    p = torch.cat([torch.full_like(r, m - 1), torch.remainder(r + k, m - 1)], dim=1)
    q = torch.cat([r, torch.remainder(r - k, m - 1)], dim=1)
    return p, q


def eigh(A: torch.Tensor, sweeps: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues [..., n] in ascending order and eigenvectors [..., n, n]
    (as columns) of the symmetric matrices A [..., n, n]. An odd n is
    padded with one decoupled row and column, dropped at the end."""
    n = A.shape[-1]
    m = n + n % 2
    batch = A.shape[:-2]
    if m != n:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(batch + (m, m))
    V = eye.clone()
    P, Q = _round_robin(m, A.device)
    for _ in range(sweeps):
        for p, q in zip(P, Q):
            app = A[..., p, p]
            aqq = A[..., q, q]
            apq = A[..., p, q]
            zero = apq == 0
            tau = (aqq - app) / torch.where(zero, 1.0, 2.0 * apq)
            t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(zero, 0.0, t)
            c = torch.rsqrt(1.0 + t * t)
            s = t * c
            J = eye.clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    w = torch.diagonal(A, dim1=-2, dim2=-1)[..., :n]
    V = V[..., :n, :n]
    w, order = torch.sort(w, dim=-1, stable=True)
    return w, torch.take_along_dim(V, order[..., None, :], dim=-1)
