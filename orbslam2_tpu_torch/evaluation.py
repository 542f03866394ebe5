# A copy of `orbslam2_tpu.utils.evaluation`, which imports no JAX, kept so that the port imports
# nothing of the reference package; tests/test_torch_no_jax.py holds the
# two equal.
"""Trajectory evaluation: ATE RMSE (TUM benchmark style) and RPE.

The reference has no evaluation code; upstream ORB-SLAM2 is scored with the
TUM `evaluate_ate.py` protocol (SURVEY.md §4): rigid (or similarity) Umeyama
alignment of estimated to ground-truth positions, then RMSE of the residual
translations.
"""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid transform src -> dst ([N, 3] each).
    Returns (s, R, t) with dst ~ s R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_poses_cw: np.ndarray,
    gt_poses_cw: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error RMSE over camera centers ([N,4,4] Tcw each)."""
    def centers(T):
        R = T[:, :3, :3]
        t = T[:, :3, 3]
        return -np.einsum("nji,nj->ni", R, t)

    c_est = centers(np.asarray(est_poses_cw))
    c_gt = centers(np.asarray(gt_poses_cw))
    if align:
        s, R, t = umeyama(c_est, c_gt, with_scale=with_scale)
        c_est = (s * (R @ c_est.T)).T + t
    err = np.linalg.norm(c_est - c_gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def rpe_rmse(est_poses_cw: np.ndarray, gt_poses_cw: np.ndarray, delta: int = 1):
    """Relative pose error (translation RMSE, rotation RMSE in rad)."""
    est = np.asarray(est_poses_cw)
    gt = np.asarray(gt_poses_cw)
    dts, drs = [], []
    for i in range(len(est) - delta):
        de = est[i + delta] @ np.linalg.inv(est[i])
        dg = gt[i + delta] @ np.linalg.inv(gt[i])
        e = de @ np.linalg.inv(dg)
        dts.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        drs.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(dts)))), float(np.sqrt(np.mean(np.square(drs))))
