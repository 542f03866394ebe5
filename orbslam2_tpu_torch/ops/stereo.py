"""RGB-D depth seeding: the virtual right coordinate of each keypoint.

Port of `orbslam2_tpu.ops.stereo.compute_stereo_from_rgbd`. Stereo
matching proper (`compute_stereo_matches`) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # [N] float32, virtual right x; <0 if unmatched
    depth: torch.Tensor    # [N] float32; <=0 if unmatched


def compute_stereo_from_rgbd(
    xy_raw: torch.Tensor,
    xy_und: torch.Tensor,
    valid: torch.Tensor,
    depth_map: torch.Tensor,
    depth_factor: float,
    bf: torch.Tensor,
) -> StereoMatches:
    """Sample the depth map at the raw (distorted) keypoint coords and
    synthesise the virtual right coordinate u - bf/d from the undistorted
    x (ORB-SLAM2 Frame::ComputeStereoFromRGBD).

    Depth-discontinuity veto: if the 3x3 depth neighbourhood has a hole or
    spans more than 10 % of the centre depth, the feature is demoted to a
    mono feature (keeps uv, drops depth and ur)."""
    H, W = depth_map.shape
    ix = torch.clamp(torch.round(xy_raw[:, 0]).to(torch.int64), 0, W - 1)
    iy = torch.clamp(torch.round(xy_raw[:, 1]).to(torch.int64), 0, H - 1)
    d = depth_map[iy, ix] * depth_factor
    nb_min = torch.full_like(d, float("inf"))
    nb_max = torch.full_like(d, -float("inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dn = depth_map[torch.clamp(iy + dy, 0, H - 1), torch.clamp(ix + dx, 0, W - 1)] * depth_factor
            nb_min = torch.minimum(nb_min, dn)
            nb_max = torch.maximum(nb_max, dn)
    flat = (nb_min > 0) & ((nb_max - nb_min) < 0.1 * torch.clamp(d, min=1e-6))
    ok = valid & (d > 0) & flat
    return StereoMatches(
        u_right=torch.where(ok, xy_und[:, 0] - bf / torch.clamp(d, min=1e-6), -1.0),
        depth=torch.where(ok, d, -1.0),
    )
