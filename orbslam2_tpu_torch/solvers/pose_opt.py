"""Pose-only optimisation: robust Gauss-Newton on a single SE(3) vertex, the
plain PyTorch version of kernel K2 (`solvers/cuda_pose_opt.py`).

Port of `orbslam2_tpu.solvers.pose_opt` (ORB-SLAM2's
Optimizer::PoseOptimization): monocular 2-D and stereo 3-D (u, v, uR)
reprojection edges with per-octave information, Huber kernels
(delta = sqrt(5.991) mono / sqrt(7.815) stereo) in the first two rounds,
and chi2 inlier reclassification after each round. Observation slots are
fixed-size masked arrays; padded slots may hold NaN and are selected out,
never multiplied by zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import Intrinsics

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObservations(NamedTuple):
    """Fixed-size observation set binding frame features to 3-D points."""

    pw: torch.Tensor          # [N, 3] world points
    uv: torch.Tensor          # [N, 2] measured pixel coords (undistorted)
    ur: torch.Tensor          # [N] measured right-x; < 0 => monocular edge
    inv_sigma2: torch.Tensor  # [N] information scale (1 / sigma^2(octave))
    mask: torch.Tensor        # [N] bool: slot holds a real observation


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor          # [4, 4] optimised pose
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor  # int
    chi2: torch.Tensor         # [N] final per-edge chi2


def _residuals_jacobians(Tcw, obs: PoseObservations, K: Intrinsics):
    """Residuals + analytic Jacobians wrt a left-multiplied twist.

    Returns (r [N, 3], J [N, 3, 6], valid_depth [N]). Row 2 is the uR
    residual, zero for mono edges."""
    pc = se3.apply(Tcw, obs.pw)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    valid_z = z > 1e-3
    zs = torch.where(valid_z, z, 1.0)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z

    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    ur_pred = u - K.bf * inv_z

    is_stereo = obs.ur >= 0
    r = torch.stack(
        [obs.uv[:, 0] - u, obs.uv[:, 1] - v, torch.where(is_stereo, obs.ur - ur_pred, 0.0)],
        dim=-1,
    )
    zero = torch.zeros_like(z)
    du = torch.stack([K.fx * inv_z, zero, -K.fx * x * inv_z2], -1)
    dv = torch.stack([zero, K.fy * inv_z, -K.fy * y * inv_z2], -1)
    dur = du + torch.stack([zero, zero, K.bf * inv_z2], -1)
    duvr = torch.stack([du, dv, torch.where(is_stereo[:, None], dur, 0.0)], dim=1)  # [N,3,3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)  # [N, 3, 6]
    J = -(duvr @ dpc)  # residual = obs - pred
    return r, J, valid_z


def _chi2(r, inv_sigma2, is_stereo):
    e2 = torch.sum(r[:, :2] ** 2, dim=-1) + torch.where(is_stereo, r[:, 2] ** 2, 0.0)
    return e2 * inv_sigma2


def solve6_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for a damped SPD 6x6 by an unrolled Cholesky
    factorisation (H must be SPD; callers damp the diagonal)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def pose_optimize(
    Tcw0: torch.Tensor,
    obs: PoseObservations,
    K: Intrinsics,
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """Run the robust rounds x iters schedule; returns pose + inliers."""
    is_stereo = obs.ur >= 0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.sqrt(chi2_th)
    eye6 = torch.eye(6, dtype=Tcw0.dtype, device=Tcw0.device)

    def gn_iter(T, use_kernel: bool, carry_mask):
        r, J, valid_z = _residuals_jacobians(T, obs, K)
        active = carry_mask & valid_z
        r = torch.where(active[:, None], r, 0.0)
        J = torch.where(active[:, None, None], J, 0.0)
        chi2 = _chi2(r, obs.inv_sigma2, is_stereo)
        en = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w_huber = torch.where(en > delta, delta / en, 1.0) if use_kernel else torch.ones_like(en)
        w = obs.inv_sigma2 * w_huber * active
        JW = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", JW, J)
        b = torch.einsum("nij,ni->j", JW, r)
        H = H + 1e-5 * eye6 * (torch.trace(H) / 6.0 + 1e-6)
        dx = solve6_spd(H, -b)
        ok = torch.all(torch.isfinite(dx)) & (torch.sum(b * b) > 1e-20)
        dx = torch.where(ok, dx, 0.0)
        return se3.exp_se3(dx) @ T

    T = Tcw0
    inlier_mask = obs.mask
    for rnd in range(rounds):
        for _ in range(iters):
            T = gn_iter(T, rnd < 2, inlier_mask)
        r, _, valid_z = _residuals_jacobians(T, obs, K)
        r = torch.where(obs.mask[:, None], r, 0.0)
        chi2 = _chi2(r, obs.inv_sigma2, is_stereo)
        inlier_mask = obs.mask & valid_z & (chi2 <= chi2_th)

    r, _, _ = _residuals_jacobians(T, obs, K)
    chi2 = _chi2(r, obs.inv_sigma2, is_stereo)
    return PoseOptResult(Tcw=T, inliers=inlier_mask, num_inliers=torch.sum(inlier_mask), chi2=chi2)
