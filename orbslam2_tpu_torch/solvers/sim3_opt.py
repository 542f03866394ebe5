"""Joint Sim(3) optimisation for loop closing.

Port of `orbslam2_tpu.solvers.sim3_opt` (ORB-SLAM2's
Optimizer::OptimizeSim3): one Sim3 vertex relating the loop candidate's
camera 2 to the current camera 1, with paired edge sets e1 = uv1 -
proj(S12 X2) in camera 1 and e2 = uv2 - proj(S12^-1 X1) in camera 2,
Huber-robust (delta = sqrt(10)), 5 Gauss-Newton iterations, a chi2 > 10
outlier cut, 10 more iterations on the survivors and a final recount.

The 7-dof tangent Jacobian is forward-mode AD through the exact Sim3 exp
map (`sim3.tangent_jacobian`, the reference's `jax.jacfwd`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import sim3
from orbslam2_tpu_torch.geometry.camera import Intrinsics

CHI2_SIM3 = 10.0  # ORB-SLAM2 Optimizer::OptimizeSim3 (deltaHuber = sqrt(10))


class Sim3OptResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor


def _project(p, K: Intrinsics):
    z = torch.clamp(p[..., 2], min=1e-3)
    return torch.stack([K.fx * p[..., 0] / z + K.cx, K.fy * p[..., 1] / z + K.cy], -1)


def _freeze_scale(d: torch.Tensor, fix_scale: bool) -> torch.Tensor:
    """sigma held at 0 when the scale is fixed (g2o's _fix_scale)."""
    return torch.cat([d[..., :6], torch.zeros_like(d[..., 6:])], -1) if fix_scale else d


def _residuals(delta, S_pack, pc1, pc2, uv1, uv2, K, fix_scale: bool):
    """Stacked residuals [..., 2N, 2] for the left-incremented vertex
    S' = exp(delta) o S; delta is [..., 1, 7] (rho, phi, sigma)."""
    S = sim3.compose(sim3.exp(_freeze_scale(delta, fix_scale)), sim3.unpack(S_pack))
    e1 = uv1 - _project(sim3.apply(S, pc2), K)                   # cam2 points into image 1
    e2 = uv2 - _project(sim3.apply(sim3.inverse(S), pc1), K)     # cam1 points into image 2
    return torch.cat([e1, e2], dim=-2)


def optimize_sim3(
    s0, R0, t0,
    pc1: torch.Tensor,        # [N, 3] matched points in camera-1 frame
    pc2: torch.Tensor,        # [N, 3] matched points in camera-2 frame
    uv1: torch.Tensor,        # [N, 2] observation of pair i in image 1
    uv2: torch.Tensor,        # [N, 2] observation of pair i in image 2
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    mask: torch.Tensor,       # [N] bool valid pairs
    K: Intrinsics,
    fix_scale: bool,
    iters1: int = 5,
    iters2: int = 10,
) -> Sim3OptResult:
    """Gauss-Newton refinement of S12 (cam2 -> cam1) over matched pairs."""
    N = pc1.shape[0]
    w_info = torch.cat([inv_sigma2_1, inv_sigma2_2])
    zero = torch.zeros((1, 7), dtype=pc1.dtype, device=pc1.device)
    eye7 = torch.eye(7, dtype=pc1.dtype, device=pc1.device)
    delta_h = CHI2_SIM3 ** 0.5

    def res(d, S_pack):
        return _residuals(d, S_pack, pc1, pc2, uv1, uv2, K, fix_scale)

    def gn_iter(S_pack, pair_mask):
        r = res(zero, S_pack)
        J = sim3.tangent_jacobian(lambda d: res(d, S_pack), zero)       # [2N, 2, 7]
        m2 = torch.cat([pair_mask, pair_mask])
        r = torch.where(m2[:, None], r, 0.0)
        J = torch.where(m2[:, None, None], J, 0.0)
        chi2 = torch.sum(r * r, -1) * w_info
        en = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = w_info * torch.where(en > delta_h, delta_h / en, 1.0) * m2
        JW = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", JW, J)
        b = torch.einsum("nij,ni->j", JW, r)
        H = H + 1e-6 * eye7 * (torch.trace(H) / 7.0 + 1e-6)
        dx = torch.linalg.solve_ex(H, b).result
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
        dx = _freeze_scale(dx, fix_scale)
        # residual = obs - pred: the step moves against the gradient
        return sim3.pack(sim3.compose(sim3.exp(-dx), sim3.unpack(S_pack)))

    def chi2_pairs(S_pack, pair_mask):
        chi2 = torch.sum(res(zero, S_pack) ** 2, -1)
        return (pair_mask & (chi2[:N] * inv_sigma2_1 <= CHI2_SIM3)
                & (chi2[N:] * inv_sigma2_2 <= CHI2_SIM3))

    S_pack = sim3.pack((torch.as_tensor(s0, dtype=pc1.dtype, device=pc1.device), R0, t0))
    for _ in range(iters1):
        S_pack = gn_iter(S_pack, mask)
    inl = chi2_pairs(S_pack, mask)
    for _ in range(iters2):
        S_pack = gn_iter(S_pack, inl)
    inl = chi2_pairs(S_pack, inl)
    s, R, t = sim3.unpack(S_pack)
    return Sim3OptResult(s=s, R=R, t=t, inliers=inl, num_inliers=torch.sum(inl))
