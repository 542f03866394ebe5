"""Batched two-view DLT triangulation.

Port of `orbslam2_tpu.geometry.triangulate`. The homogeneous 4x4 system is
solved inhomogeneously (w = 1) through its 3x3 normal equations and a
closed-form adjugate inverse, as in the reference, so degenerate pairs get
the same behind-camera sentinel and the callers' gates decide alike.
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch.geometry.camera import Intrinsics


def _projection_matrix(Tcw: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """P = K [R | t] as [..., 3, 4]."""
    return torch.einsum("ij,...jk->...ik", K.K, Tcw[..., :3, :4])


def triangulate_dlt(
    uv1: torch.Tensor, uv2: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor
) -> torch.Tensor:
    """DLT triangulation, batched: pixels [..., 2] in each view and 3x4
    projection matrices (broadcast against the batch) -> world points
    [..., 3]. Near-singular systems (parallel rays) return [0, 0, -1],
    which fails the callers' cheirality gates."""
    rows = [
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)  # [..., 4, 4]
    B = A[..., :, :3]
    c = A[..., :, 3]
    H = B.transpose(-1, -2) @ B                              # [..., 3, 3]
    g = torch.einsum("...ij,...i->...j", B, c)               # [..., 3]
    a, b_, cc = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    gg, hh, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A00 = e * i - f * hh
    A01 = cc * hh - b_ * i
    A02 = b_ * f - cc * e
    A10 = f * gg - d * i
    A11 = a * i - cc * gg
    A12 = cc * d - a * f
    A20 = d * hh - e * gg
    A21 = b_ * gg - a * hh
    A22 = a * e - b_ * d
    det = a * A00 + b_ * A10 + cc * A20
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, 1.0)
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2) / safe[..., None, None]
    p = -torch.einsum("...ij,...j->...i", adj, g)
    # the sentinel is built on the device: a tensor copied from the host
    # would wait for the card's queue
    sentinel = torch.zeros(3, dtype=p.dtype, device=p.device)
    sentinel[2] = -1.0
    return torch.where(ok[..., None], p, sentinel)


def triangulate_two_view(
    uv1: torch.Tensor, uv2: torch.Tensor, Tcw1: torch.Tensor, Tcw2: torch.Tensor, K: Intrinsics
) -> torch.Tensor:
    """Triangulate pixel matches between two posed views -> world points [..., 3]."""
    return triangulate_dlt(uv1, uv2, _projection_matrix(Tcw1, K), _projection_matrix(Tcw2, K))


def parallax_cos(pw: torch.Tensor, center1: torch.Tensor, center2: torch.Tensor) -> torch.Tensor:
    """cos of the ray parallax angle at each world point [..., 3]."""
    r1 = pw - center1
    r2 = pw - center2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
