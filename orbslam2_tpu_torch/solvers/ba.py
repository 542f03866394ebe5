"""Bundle adjustment: robust Levenberg-Marquardt with a Schur complement.

Port of `orbslam2_tpu.solvers.ba` (local and global BA of ORB-SLAM2's
Optimizer). Observations live in a per-point padded table ([P, O] slots),
so the point blocks and their elimination are batched 3x3 algebra and the
reduced camera system is a dense [C, C, 6, 6] array solved as one
[6C, 6C] linear system.

The reference accumulates the reduced system with one-hot matmuls and, for
large problems, a chunked scan: both work around slow TPU scatters. Here
the accumulation is a segment sum into the [C, C, 6, 6] system,
unchunked, in a fixed order: the edges' targets are sorted (stably) once
per problem and each target's terms are added in that order
(`torch.segment_reduce`, no atomics). A run on the card therefore gives
the same bits every time, as a run on the CPU does.

Conventions: residual r = measured - predicted; normal equations
(J^T W J) d = -J^T W r; cameras update as exp(dx) * Tcw. The LM accept /
reject is branchless (`torch.where` on the whole state), so a run of
iterations never reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.geometry.camera import Intrinsics

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. C cameras, P points, O obs slots per point."""

    cam_Tcw: torch.Tensor         # [C, 4, 4]
    cam_free: torch.Tensor        # [C] bool, False = fixed vertex
    points: torch.Tensor          # [P, 3]
    point_valid: torch.Tensor     # [P] bool
    obs_cam: torch.Tensor         # [P, O] int camera index (any value if invalid)
    obs_uv: torch.Tensor          # [P, O, 2]
    obs_ur: torch.Tensor          # [P, O] (<0 => mono edge)
    obs_inv_sigma2: torch.Tensor  # [P, O]
    obs_valid: torch.Tensor       # [P, O] bool


class BAResult(NamedTuple):
    cam_Tcw: torch.Tensor
    points: torch.Tensor
    obs_chi2: torch.Tensor        # [P, O] final per-edge chi2
    obs_inlier: torch.Tensor      # [P, O] bool, chi2 gate at the reference thresholds
    cost: torch.Tensor            # final robust cost


def _cam_index(prob: BAProblem) -> torch.Tensor:
    """obs_cam clamped into [0, C): invalid slots may hold any value, and
    the reference's gathers clamp out-of-range indices."""
    return torch.clamp(prob.obs_cam, 0, prob.cam_Tcw.shape[0] - 1).to(torch.int64)


class _Segments(NamedTuple):
    """A fixed-order sum of rows into targets: `order` sorts the rows by
    target, stably; `lengths` counts the rows of each of the `n_targets`
    targets, then of as many spare segments that hold the left-out rows."""

    order: torch.Tensor
    lengths: torch.Tensor
    n_targets: int


def _segments(target: torch.Tensor, n_targets: int) -> _Segments:
    """Rows whose target is `n_targets` or more sort last and are left out
    of every sum: they are spread evenly over `n_targets` spare segments
    (one segment of them all would be one long sequential sum), so the
    lengths add up to the row count."""
    order = torch.argsort(target, stable=True)
    bounds = torch.arange(1, n_targets + 1, dtype=target.dtype, device=target.device)
    ends = torch.searchsorted(target[order], bounds)
    used = torch.diff(ends, prepend=ends.new_zeros(1))
    rest = target.shape[0] - ends[-1]
    spare = rest // n_targets + (torch.arange(n_targets, device=target.device)
                                 < rest % n_targets)
    return _Segments(order, torch.cat([used, spare]), n_targets)


def _segment_sum(rows: torch.Tensor, seg: _Segments) -> torch.Tensor:
    """[targets, ...] sums of `rows` [R, ...], each target's rows added in
    their sorted order. The lengths add up to R by construction; `unsafe`
    skips only the check of that, which would read them back to the
    host."""
    sums = torch.segment_reduce(rows[seg.order], "sum", lengths=seg.lengths, axis=0,
                                unsafe=True)
    return sums[:seg.n_targets]


class _Assembly(NamedTuple):
    """The reduced system's accumulations, planned once per problem (the
    edges' cameras do not change between iterations)."""

    system: _Segments  # each edge's Hcc into S[c, c], then each pair of
                       # one point's edges into S[c_o, c_q]
    grad: _Segments    # each edge's gradient into g_S[c]


def _assembly(prob: BAProblem) -> _Assembly:
    """Edges of empty observation slots (their terms are exactly zero: the
    weight is 0) get the target past the end and are left out; clamped to
    camera 0 they would all fall on S[0, 0], one long sequential sum."""
    C = prob.cam_Tcw.shape[0]
    cam = _cam_index(prob)
    used = prob.obs_valid & prob.point_valid[:, None]
    edge = torch.where(used, cam, C).reshape(-1)
    pair = torch.where(used[:, :, None] & used[:, None, :],
                       cam[:, :, None] * C + cam[:, None, :], C * C).reshape(-1)
    return _Assembly(_segments(torch.cat([torch.where(edge < C, edge * (C + 1), C * C), pair]),
                               C * C),
                     _segments(edge, C))


def _edge_terms(cam_Tcw, points, prob: BAProblem, K: Intrinsics, use_kernel: bool):
    """Residuals, Jacobians and robust weights of every obs slot.

    Returns r [P,O,3], Jc [P,O,3,6], Jp [P,O,3,3], w [P,O], chi2 [P,O],
    active [P,O]."""
    cam = _cam_index(prob)
    T = cam_Tcw[cam]                                   # [P, O, 4, 4]
    pc = se3.apply(T, points[:, None, :])              # [P, O, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    valid_z = z > 1e-3
    zs = torch.where(valid_z, z, 1.0)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z

    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    ur_pred = u - K.bf * inv_z
    is_stereo = prob.obs_ur >= 0

    r = torch.stack(
        [
            prob.obs_uv[..., 0] - u,
            prob.obs_uv[..., 1] - v,
            torch.where(is_stereo, prob.obs_ur - ur_pred, 0.0),
        ],
        dim=-1,
    )
    active = prob.obs_valid & valid_z & prob.point_valid[:, None]
    r = torch.where(active[..., None], r, 0.0)

    zeros = torch.zeros_like(z)
    du = torch.stack([K.fx * inv_z, zeros, -K.fx * x * inv_z2], -1)
    dv = torch.stack([zeros, K.fy * inv_z, -K.fy * y * inv_z2], -1)
    dur = du + torch.stack([zeros, zeros, K.bf * inv_z2], -1)
    duvr = torch.stack([du, dv, torch.where(is_stereo[..., None], dur, 0.0)], dim=-2)  # [P,O,3,3]

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)   # [P,O,3,6]
    Jc = -(duvr @ dpc_dxi)
    Jp = -(duvr @ T[..., :3, :3])

    Jc = torch.where((active & prob.cam_free[cam])[..., None, None], Jc, 0.0)
    Jp = torch.where(active[..., None, None], Jp, 0.0)

    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.sqrt(chi2_th)
    e2 = torch.sum(r[..., :2] ** 2, -1) + torch.where(is_stereo, r[..., 2] ** 2, 0.0)
    chi2 = e2 * prob.obs_inv_sigma2
    en = torch.sqrt(torch.clamp(chi2, min=1e-12))
    if use_kernel:
        w_huber = torch.where(en > delta, delta / en, 1.0)
    else:
        w_huber = torch.ones_like(en)
    w = prob.obs_inv_sigma2 * w_huber * active
    return r, Jc, Jp, w, chi2, active


def _robust_cost(chi2, active, use_kernel: bool, is_stereo):
    """Sum of the Huber rho over active edges."""
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    rho = chi2
    if use_kernel:
        rho = torch.where(
            chi2 > delta2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2, chi2
        )
    return torch.sum(torch.where(active, rho, 0.0))


def inv3x3_det(h: torch.Tensor):
    """Batched closed-form (adjugate) 3x3 inverse. Returns (det, inv); the
    caller guards det ~ 0."""
    a, b, c = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    d, e, f = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    g, hh, i = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    A = e * i - f * hh
    B = c * hh - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * hh - e * g
    H = b * g - a * hh
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([D, E, F], -1),
        torch.stack([G, H, I], -1),
    ], -2)
    safe = torch.where(det == 0, 1.0, det)
    return det, adj / safe[..., None, None]


def _build_and_solve(r, Jc, Jp, w, prob: BAProblem, lam, plan: _Assembly):
    """One damped Gauss-Newton step via the Schur complement. Returns
    (dx_cam [C, 6], dp [P, 3])."""
    C = prob.cam_Tcw.shape[0]
    P, O = prob.obs_cam.shape
    dt, dev = r.dtype, r.device
    cam = _cam_index(prob)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    Wr = w[..., None] * r
    # point blocks
    Hpp = torch.einsum("poij,po,poik->pjk", Jp, w, Jp)       # [P,3,3]
    gp = torch.einsum("poij,poi->pj", Jp, Wr)                # [P,3]
    Hpp_d = Hpp + lam * eye3 * torch.clamp(
        torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0, min=1e-6
    )
    det, Hinv = inv3x3_det(Hpp_d)
    Hpp_inv = torch.where((det > 1e-12)[:, None, None], Hinv, 0.0)  # points with no obs

    # camera blocks
    Hcc_blk = torch.einsum("poij,po,poik->pojk", Jc, w, Jc)  # [P,O,6,6]
    gc_blk = torch.einsum("poij,poi->poj", Jc, Wr)           # [P,O,6]
    Wcp = torch.einsum("poij,po,poik->pojk", Jc, w, Jp)      # [P,O,6,3] = Hcp block
    Y = torch.einsum("poil,plk->poik", Wcp, Hpp_inv)         # [P,O,6,3]
    g_red = torch.einsum("poil,pl->poi", Y, gp)              # [P,O,6]

    # reduced camera system: S[c, c] += Hcc over each camera's edges, and
    # S[c_o, c_q] -= Y_o W_q^T over every pair of one point's edges
    cross = torch.einsum("poil,pqjl->poqij", Y, Wcp)         # [P,O,O,6,6]
    S = _segment_sum(torch.cat([Hcc_blk.reshape(-1, 6, 6), -cross.reshape(-1, 6, 6)]),
                     plan.system).view(C, C, 6, 6)
    g_S = _segment_sum((gc_blk - g_red).reshape(-1, 6), plan.grad)

    # damping + fixed-camera masking: zero the rows/columns of fixed
    # cameras, identity on their diagonal blocks
    free = prob.cam_free
    S = S * (free[:, None, None, None] & free[None, :, None, None])
    diag = torch.arange(C, device=dev)
    S_diag = S[diag, diag]
    damp = lam * eye6 * torch.clamp(
        torch.diagonal(S_diag, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0, min=1e-6
    )
    S[diag, diag] = S_diag + torch.where(free[:, None, None], damp, eye6)
    g_S = g_S * free[:, None]

    Sd = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    # solve_ex: `solve` would read the LU status back to the host to raise
    # on a singular system; a failed solve is caught by the finite check
    dx_cam = torch.linalg.solve_ex(Sd, -g_S.reshape(C * 6)).result.reshape(C, 6)
    dx_cam = torch.where(
        free[:, None] & torch.all(torch.isfinite(dx_cam), -1, keepdim=True), dx_cam, 0.0
    )

    # back-substitute the points: dp = Hpp^-1 (-gp - Hpc dx_c), Hpc = Wcp^T
    Hpc_dx = torch.einsum("pojk,poj->pk", Wcp, dx_cam[cam])
    dp = torch.einsum("pjk,pk->pj", Hpp_inv, -gp - Hpc_dx)
    dp = torch.where(torch.all(torch.isfinite(dp), -1, keepdim=True), dp, 0.0)
    return dx_cam, dp


def _lm_steps(prob: BAProblem, K: Intrinsics, cam, pts, lam, iters: int, use_kernel: bool):
    """Run `iters` Levenberg-Marquardt steps from (cam, pts, lam), with one
    edge evaluation per step: the candidate's terms score the step and, on
    accept, are the next linearization."""
    is_stereo = prob.obs_ur >= 0
    plan = _assembly(prob)
    terms = _edge_terms(cam, pts, prob, K, use_kernel)
    cost = _robust_cost(terms[4], terms[5], use_kernel, is_stereo)
    for _ in range(iters):
        r, Jc, Jp, w, _, _ = terms
        dx_cam, dp = _build_and_solve(r, Jc, Jp, w, prob, lam, plan)
        cam_new = se3.exp_se3(dx_cam) @ cam
        pts_new = pts + dp
        terms_new = _edge_terms(cam_new, pts_new, prob, K, use_kernel)
        new_cost = _robust_cost(terms_new[4], terms_new[5], use_kernel, is_stereo)
        accept = new_cost < cost
        cam = torch.where(accept, cam_new, cam)
        pts = torch.where(accept, pts_new, pts)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e3)
        cost = torch.where(accept, new_cost, cost)
        terms = tuple(torch.where(accept, a, b) for a, b in zip(terms_new, terms))
    return cam, pts, lam, cost


def bundle_adjust_slice(prob: BAProblem, K: Intrinsics, cam, pts, lam, iters: int,
                        use_kernel: bool):
    """One bounded slice of LM iterations with an explicit carry (cam,
    pts, lam), for the time-sliced global BA: the loop closer runs one
    slice per tracked frame. Returns (cam, pts, lam, cost). A chain of
    slices gives what one `bundle_adjust` run of all the iterations gives:
    a rejected step restores (cam, pts) and their terms together, so
    linearising again at a slice boundary changes nothing."""
    return _lm_steps(prob, K, cam, pts, lam, iters, use_kernel)


def bundle_adjust(
    prob: BAProblem, K: Intrinsics, iters: int = 10, use_kernel: bool = True, lam0: float = 1e-4
) -> BAResult:
    """Levenberg-Marquardt BA with branchless accept/reject; the final
    inlier gate uses the plain chi2 at the reference thresholds."""
    is_stereo = prob.obs_ur >= 0
    lam = torch.full((), lam0, dtype=prob.points.dtype, device=prob.points.device)
    cam, pts, _, cost = _lm_steps(prob, K, prob.cam_Tcw, prob.points, lam, iters, use_kernel)
    *_, chi2, active = _edge_terms(cam, pts, prob, K, False)
    inlier = active & (chi2 <= torch.where(is_stereo, CHI2_STEREO, CHI2_MONO))
    return BAResult(cam_Tcw=cam, points=pts, obs_chi2=chi2, obs_inlier=inlier, cost=cost)


def two_phase_bundle_adjust(
    prob: BAProblem, K: Intrinsics, iters1: int = 5, iters2: int = 10
) -> BAResult:
    """The local-BA schedule: robust iterations, drop chi2 outliers, then
    plain iterations (ORB-SLAM2 Optimizer::LocalBundleAdjustment)."""
    res1 = bundle_adjust(prob, K, iters=iters1, use_kernel=True)
    prob2 = prob._replace(
        cam_Tcw=res1.cam_Tcw, points=res1.points, obs_valid=prob.obs_valid & res1.obs_inlier
    )
    return bundle_adjust(prob2, K, iters=iters2, use_kernel=False)
