"""Pinhole camera model: projection, unprojection, radial-tangential
distortion and batched keypoint undistortion.

Port of `orbslam2_tpu.geometry.camera`. Everything is batched over
leading point dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.config import CameraConfig


class Intrinsics(NamedTuple):
    """Intrinsics as 0-d device tensors (static per session), and the
    pinhole ones packed once into the [5] tensor K2 reads."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor     # [5] = k1, k2, p1, p2, k3
    bf: torch.Tensor       # baseline * fx (stereo)
    pinhole: torch.Tensor  # [5] = fx, fy, cx, cy, bf

    @classmethod
    def of(cls, fx, fy, cx, cy, dist, bf) -> "Intrinsics":
        """From the six reference fields (0-d tensors and [5] dist)."""
        return cls(fx, fy, cx, cy, dist, bf, torch.stack([fx, fy, cx, cy, bf]))

    @classmethod
    def from_config(cls, cam: CameraConfig, device, dtype=torch.float32) -> "Intrinsics":
        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=device)

        return cls.of(
            fx=scalar(cam.fx),
            fy=scalar(cam.fy),
            cx=scalar(cam.cx),
            cy=scalar(cam.cy),
            dist=torch.tensor([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3], dtype=dtype, device=device),
            bf=scalar(cam.bf),
        )

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx]),
                torch.stack([z, self.fy, self.cy]),
                torch.stack([z, z, o]),
            ]
        )


def distort_normalized(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xd: torch.Tensor, dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert distortion by a fixed number of fixed-point iterations
    (cv::undistortPoints' scheme)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def undistort_pixels(uv: torch.Tensor, K: Intrinsics, iters: int = 8) -> torch.Tensor:
    """Undistort pixel keypoints [..., 2], re-projected with the same K."""
    xn = torch.stack([(uv[..., 0] - K.cx) / K.fx, (uv[..., 1] - K.cy) / K.fy], dim=-1)
    xu = undistort_normalized(xn, K.dist, iters)
    return torch.stack([xu[..., 0] * K.fx + K.cx, xu[..., 1] * K.fy + K.cy], dim=-1)


def project(pc: torch.Tensor, K: Intrinsics, distort: bool = False) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixel coords [..., 2].

    z is clamped away from 0 so masked/padded points stay finite."""
    z = torch.where(torch.abs(pc[..., 2:3]) < 1e-6, 1e-6, pc[..., 2:3])
    xn = pc[..., :2] / z
    if distort:
        xn = distort_normalized(xn, K.dist)
    return torch.stack([xn[..., 0] * K.fx + K.cx, xn[..., 1] * K.fy + K.cy], dim=-1)


def backproject(uv: torch.Tensor, depth: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """Pixels [..., 2] + depth [...] -> camera-frame 3D points [..., 3]."""
    x = (uv[..., 0] - K.cx) / K.fx * depth
    y = (uv[..., 1] - K.cy) / K.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def compute_image_bounds(cam: CameraConfig) -> tuple[float, float, float, float]:
    """Undistorted image bounds from the 4 corners (host-side, on the CPU)."""
    if not cam.has_distortion():
        return 0.0, float(cam.width), 0.0, float(cam.height)
    K = Intrinsics.from_config(cam, device="cpu")
    corners = torch.tensor(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height], [cam.width, cam.height]],
        dtype=torch.float32,
    )
    und = undistort_pixels(corners, K)
    xs, ys = und[:, 0], und[:, 1]
    return (
        float(torch.minimum(xs[0], xs[2])),
        float(torch.maximum(xs[1], xs[3])),
        float(torch.minimum(ys[0], ys[1])),
        float(torch.maximum(ys[2], ys[3])),
    )
