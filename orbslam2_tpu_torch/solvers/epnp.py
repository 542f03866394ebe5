"""EPnP: camera pose from 3D-2D correspondences, batched RANSAC.

Port of `orbslam2_tpu.solvers.epnp` (ORB-SLAM2's PnPsolver): every RANSAC
hypothesis runs the EPnP linear solve (control points by centroid and PCA,
barycentric coordinates, the 2n x 12 M matrix, the 4-vector kernel of
M^T M), the three beta initialisations each polished by six Gauss-Newton
steps on the control-point distances, a Horn alignment for (R, t), and the
beta case with the least reprojection error wins. The RANSAC winner is
re-solved on all its inliers.

The draw is split from the solve: `draw_pnp_samples` makes the [iters, 6]
minimal sets from a CPU `torch.Generator`, `ransac_pnp` takes them.
`_epnp_solve` computes in float64 (its eigenproblems by `sym_eigh.eigh`,
its small systems by `solve_ex`, neither reads back to the host on the
card); the inlier test is float32, as the reference computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import Intrinsics
from orbslam2_tpu_torch.solvers import sym_eigh
from orbslam2_tpu_torch.solvers.horn import draw_samples, horn_sim3


class PnPResult(NamedTuple):
    success: torch.Tensor
    Tcw: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def draw_pnp_samples(mask: torch.Tensor, iters: int, generator: torch.Generator,
                     sample_size: int = 6) -> torch.Tensor:
    """The [iters, sample_size] minimal sets of one PnP RANSAC."""
    return draw_samples(mask, iters, sample_size, generator)


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, B).result


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Damped normal equations, batched: A [..., m, k], b [..., m]."""
    At = A.transpose(-1, -2)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return _solve(At @ A + 1e-9 * eye, (At @ b[..., None]))[..., 0]


def _epnp_solve(pw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """Weighted EPnP on pw [..., N, 3], uv [..., N, 2], weights [..., N]
    (0 drops a point), batched over the leading dimensions. Returns Tcw
    [..., 4, 4] in the dtype of `pw`."""
    out_dtype = pw.dtype
    f64 = torch.float64
    pw, uv, w = pw.to(f64), uv.to(f64), w.to(f64)
    dev = pw.device
    N = pw.shape[-2]
    wn = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    c0 = torch.sum(pw * wn[..., None], dim=-2)
    q = pw - c0[..., None, :]
    cov = torch.einsum("...ni,...n,...nj->...ij", q, wn, q)
    eigval, eigvec = sym_eigh.eigh(cov, sweeps=8)
    # control points: centroid + principal axes
    scale = torch.sqrt(torch.clamp(eigval, min=1e-9))
    ctrl_w = torch.cat([c0[..., None, :],
                        c0[..., None, :] + (eigvec * scale[..., None, :]).transpose(-1, -2)], dim=-2)
    # barycentric coordinates: one [4, 4] solve for every point
    ones4 = torch.ones(ctrl_w.shape[:-2] + (1, 4), dtype=f64, device=dev)
    Cmat = torch.cat([ctrl_w.transpose(-1, -2), ones4], dim=-2)
    ph = torch.cat([pw, torch.ones(pw.shape[:-1] + (1,), dtype=f64, device=dev)], dim=-1)
    eye4 = torch.eye(4, dtype=f64, device=dev)
    alphas = _solve(Cmat + 1e-9 * eye4, ph.transpose(-1, -2)).transpose(-1, -2)  # [..., N, 4]

    # the 2N x 12 M matrix
    fu, fv, uc, vc = (x.to(f64) for x in (K.fx, K.fy, K.cx, K.cy))
    u, v = uv[..., 0], uv[..., 1]
    zero = torch.zeros_like(u)
    sw = torch.sqrt(wn)[..., None]
    ru = torch.stack([zero + fu, zero, uc - u], dim=-1)
    rv = torch.stack([zero, zero + fv, vc - v], dim=-1)
    Mu = (alphas[..., :, :, None] * ru[..., :, None, :]).reshape(alphas.shape[:-2] + (N, 12)) * sw
    Mv = (alphas[..., :, :, None] * rv[..., :, None, :]).reshape(alphas.shape[:-2] + (N, 12)) * sw
    M = torch.cat([Mu, Mv], dim=-2)
    _, vecs = sym_eigh.eigh(M.transpose(-1, -2) @ M, sweeps=10)
    # kernel basis: the 4 smallest eigenvectors, [..., basis, ctrl, 3]
    Vk = vecs[..., :, :4].transpose(-1, -2).reshape(vecs.shape[:-2] + (4, 4, 3))

    # control-point distance constraints over the 6 unordered pairs:
    # beta^T G_p beta = rho_p
    iu, ju = torch.triu_indices(4, 4, 1, device=dev)
    dv = Vk[..., :, iu, :] - Vk[..., :, ju, :]                 # [..., 4, 6, 3]
    G = torch.einsum("...kpc,...lpc->...pkl", dv, dv)          # [..., 6, 4, 4]
    dwp = ctrl_w[..., iu, :] - ctrl_w[..., ju, :]
    rho = torch.sum(dwp * dwp, dim=-1)                         # [..., 6]

    # beta initialisations (ORB-SLAM2 find_betas_approx_1/2/3)
    G00, G01, G02, G03 = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2], G[..., 0, 3]
    G11, G12 = G[..., 1, 1], G[..., 1, 2]
    b1 = _lstsq(torch.stack([G00, 2 * G01, 2 * G02, 2 * G03], dim=-1), rho)
    b1_0 = torch.sqrt(torch.abs(b1[..., 0]) + 1e-12)
    beta_c1 = torch.cat([b1_0[..., None], b1[..., 1:] / b1_0[..., None]], dim=-1)
    b2 = _lstsq(torch.stack([G00, 2 * G01, G11], dim=-1), rho)
    s2 = torch.sign(b2[..., 1]) * torch.sign(b2[..., 0] + 1e-30)
    zb = torch.zeros_like(s2)
    beta_c2 = torch.stack([torch.sqrt(torch.abs(b2[..., 0]) + 1e-12),
                           s2 * torch.sqrt(torch.abs(b2[..., 2]) + 1e-12), zb, zb], dim=-1)
    b3 = _lstsq(torch.stack([G00, 2 * G01, G11, 2 * G02, 2 * G12], dim=-1), rho)
    b3_0 = torch.sqrt(torch.abs(b3[..., 0]) + 1e-12)
    s3 = torch.sign(b3[..., 1]) * torch.sign(b3[..., 0] + 1e-30)
    beta_c3 = torch.stack([b3_0, s3 * torch.sqrt(torch.abs(b3[..., 2]) + 1e-12),
                           b3[..., 3] / b3_0, zb], dim=-1)

    # six Gauss-Newton steps on the distance constraints from each of the
    # three initialisations at once
    beta = torch.stack([beta_c1, beta_c2, beta_c3], dim=-2)    # [..., 3, 4]
    Gc = G[..., None, :, :, :]
    eye = 1e-8 * eye4
    for _ in range(6):
        Gb = torch.einsum("...pkl,...l->...pk", Gc, beta)  # [..., 3, 6, 4]
        r = torch.sum(Gb * beta[..., None, :], dim=-1) - rho[..., None, :]
        J = 2.0 * Gb
        Jt = J.transpose(-1, -2)
        beta = beta - _solve(Jt @ J + eye, Jt @ r[..., None])[..., 0]

    # recover each case's pose and score it by weighted reprojection error
    ctrl_c = torch.einsum("...k,...kij->...ij", beta, Vk[..., None, :, :, :])  # [..., 3, 4, 3]
    pc = alphas[..., None, :, :] @ ctrl_c                                       # [..., 3, N, 3]
    wn3 = wn[..., None, :]
    sign = torch.where(torch.sum(wn3 * pc[..., 2], dim=-1) < 0, -1.0, 1.0)
    pc = pc * sign[..., None, None]
    pw3 = pw[..., None, :, :].expand(pc.shape)
    _, R, t = horn_sim3(pc, pw3, w[..., None, :].expand(pc.shape[:-1]), fix_scale=True)
    T = se3.make(R, t)                                                          # [..., 3, 4, 4]
    pcr = se3.apply(T[..., None, :, :], pw3)
    z = torch.where(pcr[..., 2] > 1e-3, pcr[..., 2], 1e-3)
    du = fu * pcr[..., 0] / z + uc - u[..., None, :]
    dvv = fv * pcr[..., 1] / z + vc - v[..., None, :]
    err = torch.sum(wn3 * (du * du + dvv * dvv), dim=-1)                        # [..., 3]
    best = torch.argmin(err, dim=-1)
    T = torch.take_along_dim(T, best[..., None, None, None], dim=-3)[..., 0, :, :]
    return T.to(out_dtype)


def _reproj_chi2(Tcw, pw, uv, K: Intrinsics, inv_sigma2):
    """chi2 of every point under Tcw [..., 4, 4] (batched), and whether
    it lies in front of the camera."""
    pc = se3.apply(Tcw[..., None, :, :], pw)
    z = torch.where(pc[..., 2] > 1e-3, pc[..., 2], 1e-3)
    pu = K.fx * pc[..., 0] / z + K.cx
    pv = K.fy * pc[..., 1] / z + K.cy
    e2 = (pu - uv[..., 0]) ** 2 + (pv - uv[..., 1]) ** 2
    return e2 * inv_sigma2, pc[..., 2] > 0


def ransac_pnp(
    pw: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    inv_sigma2: torch.Tensor,
    K: Intrinsics,
    samples: torch.Tensor,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    """Batched EPnP RANSAC (ORB-SLAM2 PnPsolver::iterate): pw [N, 3] world
    points, uv [N, 2] undistorted pixels, mask [N], inv_sigma2 [N] per-match
    octave information, samples [iters, k] minimal sets."""
    idx = samples.to(torch.int64)
    Ts = _epnp_solve(pw[idx], uv[idx], torch.ones(idx.shape, dtype=pw.dtype, device=pw.device), K)
    chi2, zpos = _reproj_chi2(Ts, pw, uv, K, inv_sigma2)
    counts = torch.sum(mask & zpos & (chi2 < chi2_th), dim=-1)
    T = Ts[torch.argmax(counts).reshape(1)][0]
    chi2, zpos = _reproj_chi2(T, pw, uv, K, inv_sigma2)
    inl = mask & zpos & (chi2 < chi2_th)
    # re-solve on all inliers (the role of PnPsolver::Refine)
    T2 = _epnp_solve(pw, uv, inl.to(pw.dtype), K)
    chi2b, zposb = _reproj_chi2(T2, pw, uv, K, inv_sigma2)
    inl2 = mask & zposb & (chi2b < chi2_th)
    better = torch.sum(inl2) >= torch.sum(inl)
    inl_f = torch.where(better, inl2, inl)
    n = torch.sum(inl_f)
    return PnPResult(success=n >= min_inliers, Tcw=torch.where(better, T2, T), inliers=inl_f,
                     num_inliers=n)
