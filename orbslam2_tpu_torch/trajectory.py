# A copy of `orbslam2_tpu.io.trajectory`, which imports no JAX, kept so that the port imports
# nothing of the reference package; tests/test_torch_no_jax.py holds the
# two equal.
"""Trajectory export in TUM and KITTI formats.

Parity with `System::SaveTrajectoryTUM/KITTI` and
`SaveKeyFrameTrajectoryTUM` (reference src/System.cc:331-493): per-frame
poses are reconstructed as T_cw = T_cr * T_rw from the logged relative pose
and the (possibly loop-corrected) reference keyframe pose, then inverted to
camera-to-world for output.
"""

from __future__ import annotations

import numpy as np


def _rot_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            w = (R[2, 1] - R[1, 2]) / s
            x = 0.25 * s
            y = (R[0, 1] + R[1, 0]) / s
            z = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
            w = (R[0, 2] - R[2, 0]) / s
            x = (R[0, 1] + R[1, 0]) / s
            y = 0.25 * s
            z = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
            w = (R[1, 0] - R[0, 1]) / s
            x = (R[0, 2] + R[2, 0]) / s
            y = (R[1, 2] + R[2, 1]) / s
            z = 0.25 * s
    return np.asarray([x, y, z, w])


def save_tum(path: str, timestamps, poses_cw) -> None:
    """Write TUM format: `t tx ty tz qx qy qz qw` of the camera-to-world
    pose (reference src/System.cc:331-400)."""
    with open(path, "w") as f:
        for t, Tcw in zip(timestamps, poses_cw):
            Twc = np.linalg.inv(Tcw)
            q = _rot_to_quat_xyzw(Twc[:3, :3])
            tx, ty, tz = Twc[:3, 3]
            f.write(
                f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_kitti(path: str, poses_cw) -> None:
    """Write KITTI format: 12 floats per line, row-major 3x4 of Twc
    (reference src/System.cc:403-434)."""
    with open(path, "w") as f:
        for Tcw in poses_cw:
            Twc = np.linalg.inv(Tcw)
            row = Twc[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_tum(path: str):
    """Read a TUM trajectory -> (timestamps [N], poses_cw [N, 4, 4])."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            R = _quat_to_rot_xyzw(np.asarray([qx, qy, qz, qw]))
            Twc = np.eye(4)
            Twc[:3, :3] = R
            Twc[:3, 3] = [tx, ty, tz]
            ts.append(t)
            poses.append(np.linalg.inv(Twc))
    return np.asarray(ts), np.stack(poses)


def _quat_to_rot_xyzw(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
