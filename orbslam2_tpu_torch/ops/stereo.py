"""Stereo correspondence for rectified pairs, and RGB-D depth seeding.

Port of `orbslam2_tpu.ops.stereo`:
- `compute_stereo_matches`: a gated dense Hamming match (kernel K1) with a
  mutual left-right check, an 11x11 SAD refinement over +-5 px with a
  parabola sub-pixel fit, and a median-based outlier cut;
- `compute_stereo_from_rgbd`: the virtual right coordinate of each
  keypoint from a depth map.

The reference gathers its SAD windows from an edge-padded stack of the
pyramid levels with `lax.dynamic_slice`. Here the levels are one flat
buffer and each window is one batched gather whose row and column indices
are clamped into the feature's own level, which is what the edge padding
gives.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from orbslam2_tpu_torch.ops import cuda_hamming
from orbslam2_tpu_torch.ops.match import _masked_best2

_SAD_HALF = 5          # 11x11 window (ORB-SLAM2 w = 5)
_SLIDE = 5             # +-5 px search (ORB-SLAM2 L = 5)
_COARSE_TH = 75        # (TH_HIGH + TH_LOW) / 2


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # [N] float32, virtual right x; <0 if unmatched
    depth: torch.Tensor    # [N] float32; <=0 if unmatched


class StackedLevels(NamedTuple):
    """A pyramid as one flat buffer: level l is rows * cols values from
    `offset[l]`, row-major."""

    flat: torch.Tensor     # [sum of H_l * W_l] float32
    offset: torch.Tensor   # [L] int64
    height: torch.Tensor   # [L] int64
    width: torch.Tensor    # [L] int64


@functools.lru_cache(maxsize=16)
def _level_table(shapes: tuple, device: torch.device) -> torch.Tensor:
    """[L, 3] int64 (offset, rows, cols) of levels of `shapes`, made once
    per pyramid shape: a copy from the host waits for the device."""
    table, offset = [], 0
    for h, w in shapes:
        table.append((offset, h, w))
        offset += h * w
    return torch.tensor(table, dtype=torch.int64, device=device)


def _stack_levels(levels: Sequence[torch.Tensor]) -> StackedLevels:
    """Concatenate the levels of a pyramid into one flat buffer."""
    table = _level_table(tuple(tuple(lv.shape) for lv in levels), levels[0].device)
    return StackedLevels(flat=torch.cat([lv.reshape(-1) for lv in levels]),
                         offset=table[:, 0], height=table[:, 1], width=table[:, 2])


def _gather_level_patch(stacked: StackedLevels, level_idx, cy, cx, half_h: int, half_w: int):
    """[N, 2hh+1, 2hw+1] patches centred at (cy, cx) [N] int64 in each
    feature's level `level_idx` [N].

    The reference clips the centre into the level, then slices a window
    of the level edge-padded by (hh, hw): every row and column of the
    window is clamped into the level. Its `dynamic_slice` would clamp the
    window's start as well, but with that padding the start never leaves
    the array, so there is nothing more to reproduce."""
    h = stacked.height[level_idx]
    w = stacked.width[level_idx]
    y = torch.minimum(torch.clamp(cy, min=0), h - 1)
    x = torch.minimum(torch.clamp(cx, min=0), w - 1)
    dev = y.device
    dy = torch.arange(-half_h, half_h + 1, device=dev)
    dx = torch.arange(-half_w, half_w + 1, device=dev)
    rows = torch.minimum(torch.clamp(y[:, None] + dy, min=0), h[:, None] - 1)   # [N, 2hh+1]
    cols = torch.minimum(torch.clamp(x[:, None] + dx, min=0), w[:, None] - 1)   # [N, 2hw+1]
    idx = (stacked.offset[level_idx][:, None, None] + rows[:, :, None] * w[:, None, None]
           + cols[:, None, :])
    return stacked.flat[idx]


def compute_stereo_matches(
    left_xy: torch.Tensor,
    left_octave: torch.Tensor,
    left_desc: torch.Tensor,
    left_valid: torch.Tensor,
    right_xy: torch.Tensor,
    right_octave: torch.Tensor,
    right_desc: torch.Tensor,
    right_valid: torch.Tensor,
    left_levels: Sequence[torch.Tensor],
    right_levels: Sequence[torch.Tensor],
    scale_factors: torch.Tensor,
    bf: torch.Tensor,
    fx: torch.Tensor,
) -> StereoMatches:
    """The whole stereo match of one rectified pair (ORB-SLAM2
    Frame::ComputeStereoMatches). Coordinates are level-0 pixels; the
    disparity range is [0, fx] (depth down to the baseline)."""
    N = left_xy.shape[0]
    L = scale_factors.shape[0]
    level = torch.clamp(left_octave, 0, L - 1).to(torch.int64)
    sf_l = scale_factors[level]

    # ---- coarse: gated dense Hamming (K1), best right per left row ----
    row_tol = 2.0 * sf_l
    gate = torch.abs(left_xy[:, 1:2] - right_xy[None, :, 1]) <= row_tol[:, None]
    d_oct = right_octave[None, :] - left_octave[:, None]
    gate &= (d_oct >= -1) & (d_oct <= 1)
    disp = left_xy[:, 0:1] - right_xy[None, :, 0]
    max_d = fx  # disparity at depth == baseline
    gate &= (disp >= -3.0) & (disp <= max_d)
    gate &= left_valid[:, None] & right_valid[None, :]

    dist = cuda_hamming.distance_matrix(left_desc, right_desc)
    best_idx, best, _ = _masked_best2(dist, gate)
    # mutual left-right check: the matched right feature's best left
    # partner must be this feature (first index on ties, as jnp.argmin)
    best_left_for_right = torch.argmin(torch.where(gate, dist, 1 << 16), dim=0)
    bi = torch.clamp(best_idx, 0, N - 1).to(torch.int64)
    mutual = best_left_for_right[bi] == torch.arange(N, device=bi.device)
    coarse_ok = (best < _COARSE_TH) & mutual

    # ---- fine: SAD strip correlation at the left keypoint's octave ----
    inv_sf = 1.0 / sf_l
    uL = left_xy[:, 0] * inv_sf
    vL = left_xy[:, 1] * inv_sf
    uR0 = right_xy[bi, 0] * inv_sf
    iy = torch.round(vL).to(torch.int64)     # half to even, as jnp.round
    ixl = torch.round(uL).to(torch.int64)
    ixr = torch.round(uR0).to(torch.int64)
    W = 2 * _SAD_HALF + 1
    pl = _gather_level_patch(_stack_levels(left_levels), level, iy, ixl, _SAD_HALF, _SAD_HALF)
    pl = pl - pl[:, _SAD_HALF, _SAD_HALF, None, None]
    strip = _gather_level_patch(_stack_levels(right_levels), level, iy, ixr, _SAD_HALF,
                                _SAD_HALF + _SLIDE)                      # [N, W, W + 2 L]
    pr = strip.unfold(2, W, 1).permute(0, 2, 1, 3)                       # [N, 2L+1, W, W]
    pr = pr - pr[:, :, _SAD_HALF, _SAD_HALF, None, None]
    sads = torch.sum(torch.abs(pl[:, None] - pr), dim=(2, 3))            # [N, 2L+1]
    k = torch.argmin(sads, dim=1)
    # parabola sub-pixel fit
    km = torch.clamp(k - 1, 0, 2 * _SLIDE)
    kp = torch.clamp(k + 1, 0, 2 * _SLIDE)
    s0 = sads.gather(1, k[:, None])[:, 0]
    sl = sads.gather(1, km[:, None])[:, 0]
    sr = sads.gather(1, kp[:, None])[:, 0]
    denom = torch.clamp(2.0 * (sl + sr - 2.0 * s0), min=1e-6)
    delta = (sl - sr) / denom
    delta_ok = (torch.abs(delta) <= 1.0) & (k > 0) & (k < 2 * _SLIDE)
    delta = torch.where(delta_ok, delta, 0.0)
    u_right = (uR0 + (k.to(torch.float32) - _SLIDE) + delta) * sf_l
    disparity = left_xy[:, 0] - u_right
    fine_ok = coarse_ok & (disparity > 0.01) & (disparity < max_d)

    # ---- median outlier cut: the element at n_ok // 2 of the sorted
    # accepted SADs (rejects sort last as inf) ----
    order, _ = torch.sort(torch.where(fine_ok, s0, float("inf")))
    n_ok = torch.sum(fine_ok)
    median = order.gather(0, torch.clamp(n_ok // 2, 0, N - 1).reshape(1))[0]
    median = torch.where(torch.isfinite(median), median, 0.0)
    final_ok = fine_ok & (s0 <= 1.5 * 1.4 * median)

    return StereoMatches(
        u_right=torch.where(final_ok, u_right, -1.0),
        depth=torch.where(final_ok, bf / torch.clamp(disparity, min=1e-6), -1.0),
    )


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
