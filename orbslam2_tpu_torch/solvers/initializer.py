"""Monocular map initialization: parallel H/F RANSAC and reconstruction.

Port of `orbslam2_tpu.solvers.initializer` (ORB-SLAM2's Initializer):
every 8-point minimal set is solved and scored at once, for the
homography and for the fundamental matrix; the model is chosen by
RH = SH / (SH + SF) > 0.40, and the 4 (F) or 8 (H) motion hypotheses are
arbitrated by cheirality and reprojection (CheckRT), all batched.

The reference draws its minimal sets inside `initialize` from a JAX key.
Here the draw is its own function, `draw_init_samples`, on the CPU from
an explicit `torch.Generator`, and `initialize` takes the [iters, 8]
indices: the card and the CPU solve the same hypotheses, and a test can
feed the solver the indices the reference's key draws.

The solves, scores and motion checks run in float64, where the reference
runs float32. Each minimal set's null vector comes from the eigenvector of
A^T A with the smallest eigenvalue; in float32 two LAPACK builds (or the
card's solver and the CPU's) give vectors up to 2e-2 apart on the same
set, and on real matches the best scores tie among very different
hypotheses, so the card and the CPU would pick different ones from the
same draws. In float64 they pick the same. The results are float32.

Eigenvectors and singular vectors are defined up to sign: the scores, the
model choice and the chosen motion do not depend on it, but the order of
the motion hypotheses may differ from the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import se3, triangulate
from orbslam2_tpu_torch.geometry.camera import Intrinsics


class InitResult(NamedTuple):
    success: torch.Tensor          # bool
    T21: torch.Tensor              # [4, 4] pose of frame 2 wrt frame 1 (Tcw with world = cam1)
    points3d: torch.Tensor         # [N, 3] triangulated points (frame-1 camera coords)
    good: torch.Tensor             # [N] bool: which matches triangulated well
    used_homography: torch.Tensor  # bool


def draw_init_samples(mask: torch.Tensor, iters: int, generator: torch.Generator) -> torch.Tensor:
    """[iters, 8] int64 indices of minimal sets, drawn with replacement
    among the valid matches, on the CPU from `generator` (the reference
    draws them with `jax.random.choice(key, N, (iters, 8), p=mask / n)`)."""
    p = mask.detach().to("cpu", torch.float32)
    if not bool(p.any()):
        p = torch.ones_like(p)
    return torch.multinomial(p, iters * 8, replacement=True, generator=generator).reshape(iters, 8)


def _normalize(xy: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization over the valid rows: zero mean, unit average
    absolute deviation. Returns (normalized xy, T [3, 3])."""
    w = mask.to(xy.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (xy * w[:, None]).sum(0) / n
    md = torch.clamp((torch.abs(xy - mean) * w[:, None]).sum(0) / n, min=1e-9)
    s = 1.0 / md
    xn = (xy - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return xn, T


def _solve_nullspace(A: torch.Tensor) -> torch.Tensor:
    """Smallest right-singular vector of each A [..., R, 9], through the
    eigenvector of A^T A with the smallest eigenvalue (batched)."""
    _, v = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return v[..., :, 0]


def _compute_h(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT homography from 8 correspondences, batched: [..., 8, 2] each ->
    H21 [..., 3, 3] (ORB-SLAM2 ComputeH21)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    h = _solve_nullspace(torch.cat([r1, r2], dim=-2))      # A [..., 16, 9]
    return h.reshape(*h.shape[:-1], 3, 3)


def _compute_f(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point fundamental matrix, batched [..., 8, 2] ->
    F21 [..., 3, 3], projected to rank 2 (ORB-SLAM2 ComputeF21)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1)
    f = _solve_nullspace(A)
    f = f.reshape(*f.shape[:-1], 3, 3)
    U, D, Vt = torch.linalg.svd(f)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return U @ torch.diag_embed(D) @ Vt


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)


def _score_h(H21, x1, x2, mask, sigma2):
    """Symmetric transfer error score (ORB-SLAM2 CheckHomography), batched
    over H21 [..., 3, 3]. Returns (score [...], inliers [..., N])."""
    th = 5.991
    inv_s2 = 1.0 / sigma2
    eye = torch.eye(3, dtype=H21.dtype, device=H21.device)
    H12, _ = torch.linalg.inv_ex(H21 + 1e-12 * eye)

    def transfer(H, a, b):
        bh = torch.einsum("...ij,nj->...ni", H, _homogeneous(a))
        w = bh[..., 2:3]
        w = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
        return torch.sum((bh[..., :2] / w - b) ** 2, dim=-1)

    chi1 = transfer(H12, x2, x1) * inv_s2
    chi2 = transfer(H21, x1, x2) * inv_s2
    ok = (chi1 < th) & (chi2 < th) & mask
    score = torch.sum(torch.where(mask & (chi1 < th), th - chi1, 0.0), dim=-1) + torch.sum(
        torch.where(mask & (chi2 < th), th - chi2, 0.0), dim=-1
    )
    return score, ok


def _score_f(F21, x1, x2, mask, sigma2):
    """Epipolar distance score (ORB-SLAM2 CheckFundamental), batched over
    F21 [..., 3, 3]. Returns (score [...], inliers [..., N])."""
    th = 3.841
    th_score = 5.991
    inv_s2 = 1.0 / sigma2
    h1 = _homogeneous(x1)
    h2 = _homogeneous(x2)
    l2 = torch.einsum("...ij,nj->...ni", F21, h1)   # epipolar lines in image 2
    l1 = torch.einsum("...ji,nj->...ni", F21, h2)   # and in image 1
    d2 = torch.sum(l2 * h2, -1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * h1, -1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    c1 = d1 * inv_s2
    c2 = d2 * inv_s2
    ok = (c1 < th) & (c2 < th) & mask
    score = torch.sum(torch.where(mask & (c1 < th), th_score - c1, 0.0), dim=-1) + torch.sum(
        torch.where(mask & (c2 < th), th_score - c2, 0.0), dim=-1
    )
    return score, ok


def _check_rt(R, t, x1, x2, mask, K: Intrinsics, sigma2):
    """Cheirality and reprojection test of motion hypotheses (ORB-SLAM2
    CheckRT), batched: R [H, 3, 3], t [H, 3], matches [N, 2].

    Returns (n_good [H], good [H, N], parallax cos of the 50th best point
    [H], points3d [H, N, 3])."""
    T1 = se3.identity(dtype=R.dtype, device=R.device)
    T2 = se3.make(R, t)                                           # [H, 4, 4]
    Hn = (R.shape[0], -1, -1)
    pw = triangulate.triangulate_two_view(x1.expand(Hn), x2.expand(Hn), T1, T2[:, None], K)
    finite = torch.all(torch.isfinite(pw), -1)
    pc1 = pw
    pc2 = se3.apply(T2[:, None], pw)
    c1 = torch.zeros(3, dtype=pw.dtype, device=pw.device)
    c2 = se3.camera_center(T2)[:, None]
    cosp = triangulate.parallax_cos(pw, c1, c2)
    z_ok = (pc1[..., 2] > 0) & (pc2[..., 2] > 0)
    fx, fy, cx, cy = K.fx, K.fy, K.cx, K.cy
    p1 = torch.stack([fx * pc1[..., 0] / pc1[..., 2] + cx, fy * pc1[..., 1] / pc1[..., 2] + cy], -1)
    p2 = torch.stack([fx * pc2[..., 0] / pc2[..., 2] + cx, fy * pc2[..., 1] / pc2[..., 2] + cy], -1)
    e1 = torch.sum((p1 - x1) ** 2, -1)
    e2 = torch.sum((p2 - x2) ** 2, -1)
    th2 = 4.0 * sigma2
    good = mask & finite & z_ok & (e1 < th2) & (e2 < th2) & (cosp < 0.99998)
    n_good = torch.sum(good, dim=-1)
    # parallax of the 50th best point (ORB-SLAM2 takes the 50th smallest)
    cos_sorted, _ = torch.sort(torch.where(good, cosp, 1.0), dim=-1)
    idx = torch.clamp(n_good - 1, min=0, max=49)
    par = cos_sorted.gather(1, idx[:, None])[:, 0]
    return n_good, good, par, pw


def _h_motions(H21: torch.Tensor, Km: torch.Tensor):
    """The 8 motions of a homography (Faugeras; ORB-SLAM2 ReconstructH):
    (R [8, 3, 3], t [8, 3]), unit t."""
    A = torch.linalg.inv_ex(Km)[0] @ H21 @ Km
    Ua, Da, Vta = torch.linalg.svd(A)
    d1, d2, d3 = Da[0], Da[1], Da[2]
    s_det = torch.linalg.det(Ua) * torch.linalg.det(Vta)
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1v = torch.stack([aux1, aux1, -aux1, -aux1])
    x3v = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    aux_st = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    st = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    aux_sp = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sp = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])
    z, o = torch.zeros_like(st), torch.ones_like(st)
    ctv, cpv = ct.expand(4), cp.expand(4)
    # d' > 0: Rp = [[c, 0, -s], [0, 1, 0], [s, 0, c]], tp = (x1, 0, -x3)(d1 - d3)
    Rp_pos = torch.stack([torch.stack([ctv, z, -st], -1), torch.stack([z, o, z], -1),
                          torch.stack([st, z, ctv], -1)], -2)
    tp_pos = torch.stack([x1v, z, -x3v], -1) * (d1 - d3)
    # d' < 0: Rp = [[c, 0, s], [0, -1, 0], [s, 0, -c]], tp = (x1, 0, x3)(d1 + d3)
    Rp_neg = torch.stack([torch.stack([cpv, z, sp], -1), torch.stack([z, -o, z], -1),
                          torch.stack([sp, z, -cpv], -1)], -2)
    tp_neg = torch.stack([x1v, z, x3v], -1) * (d1 + d3)
    Rp = torch.cat([Rp_pos, Rp_neg])
    tp = torch.cat([tp_pos, tp_neg])
    R = s_det * Ua @ Rp @ Vta
    t = tp @ Ua.T
    return R, t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-9)


def initialize(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    mask: torch.Tensor,
    K: Intrinsics,
    samples: torch.Tensor,
    sigma: float = 1.0,
) -> InitResult:
    """The whole two-view bootstrap. xy1 / xy2 [N, 2] matched undistorted
    pixels, mask [N] the valid matches, samples [iters, 8] the minimal
    sets (`draw_init_samples`)."""
    sigma2 = sigma * sigma
    samples = samples.to(xy1.device)
    xy1, xy2 = xy1.to(torch.float64), xy2.to(torch.float64)
    K = Intrinsics(*(x.to(torch.float64) for x in K))
    x1n, T1 = _normalize(xy1, mask)
    x2n, T2 = _normalize(xy2, mask)

    # every minimal set's H and F, one batch each
    Hn = _compute_h(x1n[samples], x2n[samples])
    Hs = torch.linalg.inv_ex(T2)[0] @ Hn @ T1
    sh, _ = _score_h(Hs, xy1, xy2, mask, sigma2)
    Fn = _compute_f(x1n[samples], x2n[samples])
    Fs = T2.T @ Fn @ T1
    sf, _ = _score_f(Fs, xy1, xy2, mask, sigma2)
    # the winners are indexed with [1] tensors, which stay on the device
    bh = torch.argmax(sh, dim=0, keepdim=True)
    bf = torch.argmax(sf, dim=0, keepdim=True)
    SH, H21 = sh[bh][0], Hs[bh][0]
    SF, F21 = sf[bf][0], Fs[bf][0]
    _, inl_h = _score_h(H21, xy1, xy2, mask, sigma2)
    _, inl_f = _score_f(F21, xy1, xy2, mask, sigma2)
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    # F -> E -> 4 motions (ORB-SLAM2 DecomposeE + ReconstructF)
    Km = K.K
    E = Km.T @ F21 @ Km
    U, _, Vt = torch.linalg.svd(E)
    W = torch.zeros(3, 3, dtype=E.dtype, device=E.device)
    W[0, 1], W[1, 0], W[2, 2] = -1.0, 1.0, 1.0
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tu = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-9)
    f_Rs = torch.stack([R1, R1, R2, R2])
    f_ts = torch.stack([tu, -tu, tu, -tu])
    h_Rs, h_ts = _h_motions(H21, Km)

    # all 12 hypotheses are checked; only the chosen family can win
    inliers = torch.where(use_h, inl_h, inl_f)
    all_Rs = torch.cat([f_Rs, h_Rs])
    all_ts = torch.cat([f_ts, h_ts])
    fam_ok = torch.cat([(~use_h).expand(4), use_h.expand(8)])
    n_good, goods, pars, pws = _check_rt(all_Rs, all_ts, xy1, xy2, inliers, K, 4.0 * sigma2)
    n_good = torch.where(fam_ok, n_good, -1)
    best = torch.argmax(n_good, dim=0, keepdim=True)
    best_n = n_good[best][0]
    second_n = torch.sort(n_good).values[-2]
    min_good = torch.clamp(0.9 * torch.sum(inliers), min=50.0)
    # a unique winner, enough support and enough parallax
    ok = (best_n.to(torch.float32) > min_good) & (second_n < 0.75 * best_n) & (pars[best][0] < 0.9998)
    return InitResult(
        success=ok,
        T21=se3.make(all_Rs[best][0], all_ts[best][0]).to(torch.float32),
        points3d=pws[best][0].to(torch.float32),
        good=goods[best][0],
        used_homography=use_h,
    )
