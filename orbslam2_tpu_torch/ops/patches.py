"""Batched square-patch gathering and intensity-centroid orientation.

Port of `orbslam2_tpu.ops.patches` (the parts the extractor uses).
"""

from __future__ import annotations

import torch


def gather_patches_stack_mc(
    stack: torch.Tensor, level: torch.Tensor, xy: torch.Tensor, half: int
) -> torch.Tensor:
    """Gather (2*half+1)^2 patches for keypoints spread across pyramid
    levels, all channels at once.

    stack: [L, Hp, Wp, C] canvas of per-level images, each padded by
    `half` and placed at the origin; level: [N] int level per keypoint;
    xy: [N, 2] keypoint centres in level-local coords (= the patch's
    top-left corner in padded coords). Returns [N, S, S, C], S = 2*half+1.
    """
    size = 2 * half + 1
    L, Hp, Wp, _ = stack.shape
    ix = torch.clamp(xy[:, 0].to(torch.int64), 0, Wp - size)
    iy = torch.clamp(xy[:, 1].to(torch.int64), 0, Hp - size)
    lv = torch.clamp(level.to(torch.int64), 0, L - 1)
    off = torch.arange(size, device=stack.device)
    rows = (iy[:, None] + off)[:, :, None]        # [N, S, 1]
    cols = (ix[:, None] + off)[:, None, :]        # [N, 1, S]
    return stack[lv[:, None, None], rows, cols]   # [N, S, S, C]


def ic_angle(patches: torch.Tensor, half: int = 15) -> torch.Tensor:
    """Intensity-centroid orientation per patch (radians): atan2(m01, m10)
    over the disk of radius `half`. patches: [N, S, S], S = 2*half+1."""
    size = 2 * half + 1
    ys = torch.arange(size, dtype=torch.float32, device=patches.device) - half
    xs = torch.arange(size, dtype=torch.float32, device=patches.device) - half
    yy = ys[:, None]
    xx = xs[None, :]
    mask = (yy * yy + xx * xx) <= float(half * half) + 1e-3
    wx = torch.where(mask, xx, 0.0)
    wy = torch.where(mask, yy, 0.0)
    m10 = torch.einsum("nij,ij->n", patches, wx)
    m01 = torch.einsum("nij,ij->n", patches, wy)
    return torch.arctan2(m01, m10)
