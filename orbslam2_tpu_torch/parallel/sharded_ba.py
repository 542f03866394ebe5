"""Bundle adjustment with the map points sharded over a process group.

Port of `orbslam2_tpu.parallel.sharded_ba`. Each rank holds a block of the
points and their observation rows, eliminates its points (batched 3x3
Schur) and assembles its part of the reduced [C, C, 6, 6] camera system
with the single-device solver's own code (`solvers.ba`); the point-side
work never crosses ranks. Two camera solves:

* `camera_solver="direct"`: the system and its right-hand side are
  all-reduced and solved densely on every rank. At world size 1 this is
  `solvers.ba.bundle_adjust` step for step;
* `camera_solver="pcg"`: the system is reduce-scattered over camera rows
  (each rank owns C/n rows, padded to a multiple of n) and solved by
  block-Jacobi preconditioned CG; each CG step all-gathers one [C, 6]
  vector, and nothing O(C^2) is replicated.

The points' back-substitution stays local, and the LM accept / reject
reads the robust cost all-reduced over the ranks. Nothing is read back to
the host: an adjustment is one chain of launches and collectives.
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch.geometry.camera import Intrinsics
from orbslam2_tpu_torch.parallel import group
from orbslam2_tpu_torch.solvers import ba


def _direct_cameras(S, g_S, free, lam):
    return ba.solve_cameras(group.psum(S), group.psum(g_S), free, lam)


def solve_cameras_pcg(S, g_S, free, lam, cg_iters: int):
    """The camera update [C, 6] of the sum over the ranks of the partial
    reduced systems `S` [C, C, 6, 6] and `g_S` [C, 6], by block-Jacobi
    preconditioned CG over row-scattered blocks, with the damping and the
    fixed-camera masking of `solvers.ba.solve_cameras`. Called in every
    rank; every rank gets the update."""
    C = S.shape[0]
    n = group.size()
    dev, dt = S.device, S.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    # pad the camera rows to a multiple of the group size; padded rows are
    # fixed: identity diagonal, zero right-hand side
    pad = (-C) % n
    free_p = torch.cat([free, torch.zeros(pad, dtype=torch.bool, device=dev)])
    Sl = group.psum_scatter(torch.cat([S, S.new_zeros((pad, C, 6, 6))]))
    gl = group.psum_scatter(torch.cat([g_S, g_S.new_zeros((pad, 6))]))
    Cl = Sl.shape[0]
    local = torch.arange(Cl, device=dev)
    rows = group.axis_index() * Cl + local
    free_r = free_p[rows]
    Sl = Sl * (free_r[:, None, None, None] & free[None, :, None, None])
    # the damped diagonal blocks; fixed and padded rows pinned to identity
    rows_c = torch.clamp(rows, max=C - 1)
    diag = Sl[local, rows_c]
    damp = lam * torch.clamp(torch.diagonal(diag, dim1=-2, dim2=-1).sum(-1) / 6.0, min=1e-6)
    diag = torch.where(free_r[:, None, None], diag + damp[:, None, None] * eye6, eye6)
    Sl = Sl.index_put((local, rows_c), diag)
    b = group.all_gather(torch.where(free_r[:, None], -gl, 0.0))[:C]
    # block-Jacobi preconditioner: each camera's 6x6 diagonal block
    L = torch.linalg.cholesky_ex(group.all_gather(diag)[:C] + 1e-8 * eye6).L

    def precond(r):
        return torch.cholesky_solve(r[..., None], L)[..., 0]

    def matvec(p):
        return group.all_gather(torch.einsum("acij,cj->ai", Sl, p))[:C]

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > 1e-20, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    return torch.where(free[:, None] & torch.all(torch.isfinite(x), -1, keepdim=True), x, 0.0)


def sharded_bundle_adjust(prob: ba.BAProblem, K: Intrinsics, iters: int = 10,
                          use_kernel: bool = True, lam0: float = 1e-4,
                          camera_solver: str = "direct", cg_iters: int = 48):
    """Levenberg-Marquardt BA with the points sharded over the group,
    called in every rank with the whole problem (the point count a
    multiple of the group size). Returns (cam_Tcw [C, 4, 4], points
    [P, 3], cost) on every rank."""
    if camera_solver == "direct":
        camera_solve = _direct_cameras
    elif camera_solver == "pcg":
        def camera_solve(S, g_S, free, lam):
            return solve_cameras_pcg(S, g_S, free, lam, cg_iters)
    else:
        raise ValueError(f"camera_solver must be 'direct' or 'pcg', not {camera_solver!r}")
    mine = group.rows(prob.points.shape[0])
    local = prob._replace(**{f: getattr(prob, f)[mine] for f in (
        "points", "point_valid", "obs_cam", "obs_uv", "obs_ur", "obs_inv_sigma2", "obs_valid")})
    lam = torch.full((), lam0, dtype=prob.points.dtype, device=prob.points.device)
    cam, pts, _, cost = ba._lm_steps(local, K, prob.cam_Tcw, local.points, lam, iters,
                                     use_kernel, camera_solve, total=group.psum)
    return cam, group.all_gather(pts), cost
