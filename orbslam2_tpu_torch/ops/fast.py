"""FAST-9/16 corner detection as a whole-image vectorised pass.

Port of `orbslam2_tpu.ops.fast`: every pixel is scored at once. The 16
Bresenham-circle neighbours are 16 shifted views of the edge-padded image,
the "contiguous arc of >= 9" test is bit arithmetic on a packed 16-bit ring
mask, the score is the larger of the two polarities' summed thresholded
differences, and non-max suppression compares against the 3x3
neighbourhood. Corners are found at the low (retry) and high threshold in
one pass. Every function takes a leading batch of images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LENGTH = 9


def _ring_stack(image: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [16, B, H, W] of circle-neighbour intensities
    (edge-replicated borders)."""
    B, H, W = image.shape
    padded = F.pad(image[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    return torch.stack(
        [padded[:, 3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for dy, dx in CIRCLE_OFFSETS]
    )


def _has_arc(mask_bits: torch.Tensor) -> torch.Tensor:
    """mask_bits: integer tensor with 16 ring bits set. True where a
    circular run of >= ARC_LENGTH (9) consecutive set bits exists: doubling
    the ring into 32 bits makes circular runs linear, then run length >= 9
    is an AND of shifts with strides (1, 2, 4, 1)."""
    x = mask_bits | (mask_bits << 16)
    x = x & (x >> 1)   # runs >= 2
    x = x & (x >> 2)   # runs >= 4
    x = x & (x >> 4)   # runs >= 8
    x = x & (x >> 1)   # runs >= 9
    return (x & 0xFFFF) != 0


def fast_score_map2(image: torch.Tensor, th_lo: float, th_hi: float):
    """Dense FAST response at two thresholds sharing one ring-difference
    pass. image: [B, H, W] float32 (0..255).

    Returns (corner_lo [B, H, W] bool, corner_hi [B, H, W] bool,
    score [B, H, W] float32 at th_lo)."""
    diff = _ring_stack(image) - image[None]          # [16, B, H, W]
    weights = (1 << torch.arange(16, dtype=torch.int64, device=image.device))
    weights = weights[:, None, None, None]

    def corner_at(th):
        b_bits = torch.sum(torch.where(diff > th, weights, 0), dim=0)
        d_bits = torch.sum(torch.where(diff < -th, weights, 0), dim=0)
        return _has_arc(b_bits) | _has_arc(d_bits)

    corner_lo = corner_at(th_lo)
    corner_hi = corner_at(th_hi)
    b_score = torch.sum(torch.clamp(diff - th_lo, min=0.0), dim=0)
    d_score = torch.sum(torch.clamp(-diff - th_lo, min=0.0), dim=0)
    return corner_lo, corner_hi, torch.maximum(b_score, d_score)


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """[B, H, W]: True where score >= every value of its 3x3 neighbourhood."""
    B, H, W = score.shape
    padded = F.pad(score, (1, 1, 1, 1), mode="constant", value=-float("inf"))
    neigh = torch.stack(
        [
            padded[:, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ]
    )
    return score >= torch.amax(neigh, dim=0)


def detect_stack(
    images: torch.Tensor,
    shapes,
    ini_threshold: float,
    min_threshold: float,
    border: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dual-threshold FAST with NMS and border masking over a stack of
    pyramid levels sharing one canvas: `images` is [L, Hc, Wc] with each
    level at the origin and zeros elsewhere, `shapes` the per-level (H, W).

    The border mask keeps every survivor >= `border` px inside its own
    level, so canvas padding never reaches a kept corner.

    Returns (score [L, Hc, Wc], -inf where no corner passes even the low
    threshold; strong [L, Hc, Wc] bool, the high-threshold corners)."""
    corner_lo, corner_hi, score = fast_score_map2(
        images, float(min_threshold), float(ini_threshold)
    )
    dev = images.device
    Hc, Wc = images.shape[1], images.shape[2]
    ys = torch.arange(Hc, device=dev)[None, :, None]
    xs = torch.arange(Wc, device=dev)[None, None, :]
    hs = torch.tensor([h for h, _ in shapes], device=dev)[:, None, None]
    ws = torch.tensor([w for _, w in shapes], device=dev)[:, None, None]
    in_border = (ys >= border) & (ys < hs - border) & (xs >= border) & (xs < ws - border)
    keep = corner_lo & in_border & nms_3x3(torch.where(corner_lo, score, -float("inf")))
    score = torch.where(keep, score, -float("inf"))
    return score, corner_hi & keep


def detect(
    image: torch.Tensor,
    ini_threshold: float,
    min_threshold: float,
    border: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-image `detect_stack`: [H, W] -> (score [H, W], strong [H, W])."""
    score, strong = detect_stack(
        image[None], (tuple(image.shape),), ini_threshold, min_threshold, border
    )
    return score[0], strong[0]
