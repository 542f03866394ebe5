"""Closed-form Sim(3) estimation (Horn's quaternion method) and a batched
RANSAC over it.

Port of `orbslam2_tpu.solvers.horn` (ORB-SLAM2's Sim3Solver). The draw is
split from the solve: `draw_sim3_samples` makes the [iters, 3] minimal sets
from a CPU `torch.Generator` (the reference draws with `jax.random`, which
torch cannot reproduce), and `ransac_sim3` takes them, so a test can feed
it the reference's sets. Every hypothesis solves Horn's absolute
orientation and is scored by mutual reprojection, all in one batch.

Horn's 4x4 eigenproblem is solved in float64 by `sym_eigh.eigh` (no host
read on the card); the rest is float32, as the reference computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import Intrinsics
from orbslam2_tpu_torch.solvers import sym_eigh


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s: torch.Tensor          # scale
    R: torch.Tensor          # [3, 3]
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [N] bool
    num_inliers: torch.Tensor


def draw_samples(mask: torch.Tensor, iters: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """[iters, k] indices drawn with replacement, uniformly among the
    entries where `mask` holds (the reference's `jax.random.choice` with
    p = mask / n). The uniforms come from `generator` on the CPU; the
    choice is made where `mask` lies with an integer cumulative count, so
    the card and the CPU pick the same indices and nothing is read back to
    the host. With no entry set the draw is uniform over all N."""
    u = torch.rand((iters, k), generator=generator, dtype=torch.float64)
    u = u.to(mask.device, non_blocking=True)
    m = mask.reshape(-1)
    N = m.shape[0]
    cum = torch.cumsum(m.to(torch.int64), dim=0)
    n = cum[-1:]
    uniform = n == 0
    total = torch.where(uniform, N, n).to(torch.float64)
    target = torch.clamp(torch.floor(u * total).to(torch.int64), max=total.to(torch.int64) - 1)
    cdf = torch.where(uniform, torch.arange(1, N + 1, device=m.device), cum)
    return torch.searchsorted(cdf, target, right=True)


def draw_sim3_samples(mask: torch.Tensor, iters: int, generator: torch.Generator) -> torch.Tensor:
    """The [iters, 3] minimal sets of one Sim3 RANSAC."""
    return draw_samples(mask, iters, 3, generator)


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor, fix_scale: bool = False):
    """Weighted closed-form similarity aligning p2 -> p1: p1 ~ s R p2 + t.

    p1, p2: [..., N, 3]; w: [..., N] weights (0/1 masks fine). Batched over
    the leading dimensions. Returns (s, R, t)."""
    wn = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    c1 = torch.sum(p1 * wn[..., None], dim=-2)
    c2 = torch.sum(p2 * wn[..., None], dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = torch.einsum("...ni,...n,...nj->...ij", q1, wn, q2)  # sum w q1 q2^T
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    Nm = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, vecs = sym_eigh.eigh(Nm.to(torch.float64), sweeps=8)
    q = vecs[..., :, -1].to(p1.dtype)  # largest eigenvalue -> quaternion (w, x, y, z)
    # this quaternion rotates frame 1 into frame 2; p1 ~ s R p2 + t takes
    # its transpose
    R = se3.quat_to_rot(q).transpose(-1, -2)
    Rq2 = q2 @ R.transpose(-1, -2)
    num = torch.sum(w[..., None] * q1 * Rq2, dim=(-1, -2))
    den = torch.sum(w[..., None] * q2 * q2, dim=(-1, -2))
    s = torch.ones_like(num) if fix_scale else num / torch.clamp(den, min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return s, R, t


def _project(p, K: Intrinsics, z_eps=1e-3):
    z = torch.clamp(p[..., 2], min=z_eps)
    return torch.stack([K.fx * p[..., 0] / z + K.cx, K.fy * p[..., 1] / z + K.cy], -1)


def _mutual_inliers(s, R, t, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, mask, K: Intrinsics,
                    cheirality: bool):
    """Pairs whose reprojection both ways lies within 9.21 sigma^2 (and,
    with `cheirality`, in front of both cameras). s, R, t may carry a
    leading hypothesis dimension."""
    p2in1 = s[..., None, None] * (pc2 @ R.transpose(-1, -2)) + t[..., None, :]
    sinv = 1.0 / torch.clamp(s, min=1e-9)
    p1in2 = sinv[..., None, None] * ((pc1 - t[..., None, :]) @ R)
    e1 = torch.sum((_project(p2in1, K) - uv1) ** 2, -1)
    e2 = torch.sum((_project(p1in2, K) - uv2) ** 2, -1)
    inl = mask & (e1 < 9.21 * sigma2_1) & (e2 < 9.21 * sigma2_2)
    if cheirality:
        inl = inl & (p2in1[..., 2] > 0) & (p1in2[..., 2] > 0)
    return inl


def ransac_sim3(
    p1: torch.Tensor,
    p2: torch.Tensor,
    mask: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    sigma2_1: torch.Tensor,
    sigma2_2: torch.Tensor,
    Tcw1: torch.Tensor,
    Tcw2: torch.Tensor,
    K: Intrinsics,
    samples: torch.Tensor,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3Result:
    """Batched Sim3 RANSAC over matched 3-D point pairs (ORB-SLAM2
    Sim3Solver::iterate and CheckInliers).

    p1/p2 are world points observed by KF1/KF2 (moved into each camera
    first), uv1/uv2 their pixels, sigma2_* the per-pair chi2 scales;
    `samples` [iters, 3] the minimal sets. The best hypothesis is re-solved
    on its inliers; the re-solve is kept when it has at least as many."""
    pc1 = se3.apply(Tcw1, p1)
    pc2 = se3.apply(Tcw2, p2)
    idx = samples.to(torch.int64)
    ss, Rs, ts = horn_sim3(pc1[idx], pc2[idx], torch.ones(idx.shape, dtype=pc1.dtype,
                                                           device=pc1.device), fix_scale)
    args = (pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, mask, K)
    counts = torch.sum(_mutual_inliers(ss, Rs, ts, *args, cheirality=True), -1)
    best = torch.argmax(counts).reshape(1)
    s, R, t = ss[best][0], Rs[best][0], ts[best][0]
    inl = _mutual_inliers(s, R, t, *args, cheirality=False)
    s2, R2, t2 = horn_sim3(pc1, pc2, inl.to(pc1.dtype), fix_scale)
    inl2 = _mutual_inliers(s2, R2, t2, *args, cheirality=False)
    better = torch.sum(inl2) >= torch.sum(inl)
    inl_f = torch.where(better, inl2, inl)
    n = torch.sum(inl_f)
    return Sim3Result(success=n >= min_inliers, s=torch.where(better, s2, s),
                      R=torch.where(better, R2, R), t=torch.where(better, t2, t),
                      inliers=inl_f, num_inliers=n)
