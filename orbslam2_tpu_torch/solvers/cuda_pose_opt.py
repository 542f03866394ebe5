"""K2: the whole robust pose Gauss-Newton schedule as one hand-written
CUDA kernel launch (`csrc/pose_gn.cu`), replacing the Pallas kernel of
`orbslam2_tpu.solvers.pallas_pose_opt`.

`pose_optimize_fast` takes the plain version (`solvers/pose_opt.py`) for
tensors on the CPU and the kernel for tensors on a CUDA device; nothing
else chooses between them.
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.geometry.camera import Intrinsics
from orbslam2_tpu_torch.solvers import pose_opt
from orbslam2_tpu_torch.solvers.pose_opt import PoseObservations, PoseOptResult


def launch(Tcw0, obs: PoseObservations, kp, rounds: int, iters: int, T, inliers, chi2,
           num_inliers) -> None:
    """One K2 launch on the current stream into preallocated outputs; no
    checks, no allocation. `pose_optimize_cuda` is the checked entry
    point; this is also what a timing loop captures."""
    err = kernels.library().pose_gn(
        obs.pw.data_ptr(), obs.uv.data_ptr(), obs.ur.data_ptr(),
        obs.inv_sigma2.data_ptr(), obs.mask.data_ptr(), kp.data_ptr(),
        Tcw0.data_ptr(), obs.pw.shape[0], rounds, iters,
        T.data_ptr(), inliers.data_ptr(), chi2.data_ptr(), num_inliers.data_ptr(),
        kernels.stream_handle(Tcw0.device),
    )
    kernels.check_launch("pose_gn", err)
    kernels.launch_counts["pose_gn"] += 1


def pose_optimize_cuda(
    Tcw0: torch.Tensor,
    obs: PoseObservations,
    K: Intrinsics,
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """Drop-in replacement for pose_opt.pose_optimize on the card, one
    kernel launch and nothing else: the intrinsics come packed
    (`K.pinhole`) and the kernel counts the inliers itself. The returned
    chi2 is zero outside `obs.mask`. At most `kernels.POSE_GN_MAX_SLOTS`
    (2560) observation slots."""
    n = obs.pw.shape[0]
    f32 = (Tcw0, obs.pw, obs.uv, obs.ur, obs.inv_sigma2, K.pinhole)
    kernels.require_cuda("pose_gn", *f32, obs.mask)
    if any(t.dtype != torch.float32 for t in f32) or obs.mask.dtype != torch.bool:
        raise ValueError("pose_gn: expected float32 poses/observations/intrinsics and a bool mask")
    if (Tcw0.shape != (4, 4) or obs.pw.shape != (n, 3) or obs.uv.shape != (n, 2)
            or obs.ur.shape != (n,) or obs.inv_sigma2.shape != (n,) or obs.mask.shape != (n,)
            or K.pinhole.shape != (5,)):
        raise ValueError("pose_gn: expected Tcw0 [4,4], pw [N,3], uv [N,2], ur/inv_sigma2/mask [N]"
                         " and K.pinhole [5]")
    if rounds < 0 or iters < 0:
        raise ValueError("pose_gn: rounds and iters must be >= 0")
    if n > kernels.POSE_GN_MAX_SLOTS:
        raise ValueError(f"pose_gn: {n} slots, more than the kernel's {kernels.POSE_GN_MAX_SLOTS}")
    dev = Tcw0.device
    T = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty((n,), dtype=torch.bool, device=dev)
    chi2 = torch.empty((n,), dtype=torch.float32, device=dev)
    num_inliers = torch.empty((), dtype=torch.int64, device=dev)
    launch(Tcw0, obs, K.pinhole, rounds, iters, T, inliers, chi2, num_inliers)
    return PoseOptResult(Tcw=T, inliers=inliers, num_inliers=num_inliers, chi2=chi2)


def pose_optimize_fast(Tcw0, obs: PoseObservations, K: Intrinsics, rounds: int = 4, iters: int = 10):
    """Dispatch on where the tensors lie: the kernel on a CUDA device, the
    plain version on the CPU."""
    if Tcw0.device.type == "cpu":
        return pose_opt.pose_optimize(Tcw0, obs, K, rounds=rounds, iters=iters)
    return pose_optimize_cuda(Tcw0, obs, K, rounds=rounds, iters=iters)
