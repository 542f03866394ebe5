"""ORB feature extraction: FAST + orientation + steered BRIEF over a pyramid.

Port of `orbslam2_tpu.ops.orb`. FAST runs densely over every level, a
grid-bucketed rank selection replaces the reference's quadtree, the
orientation is a masked moment reduction and the descriptor is steered
BRIEF over a fixed seeded Gaussian point pattern, packed 256 bits -> 8
words. Output shapes are static: `feature_slots` padded slots with a
validity mask.

Descriptors are [*, 8] int32 holding the same bits as the reference
package's [*, 8] uint32 (PyTorch supports few ops on uint32).

Ties follow the reference: `torch.argmax` takes the first index, and the
selection's top-k is a stable sort, so equal keys keep the lower index
first as `lax.top_k` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from orbslam2_tpu_torch import profiling
from orbslam2_tpu_torch.config import OrbConfig
from orbslam2_tpu_torch.ops import fast, patches, pyramid

_PATTERN_RADIUS = 12.5


def make_brief_pattern(seed: int = 7, n_bits: int = 256) -> np.ndarray:
    """Generate a 256-pair BRIEF sampling pattern, [n_bits, 4] = (x1,y1,x2,y2).

    Pairs drawn i.i.d. from N(0, (patch/5)^2) clipped to a disk of radius
    12.5 so any rotation keeps samples inside the 31x31 patch. A copy of
    `orbslam2_tpu.ops.orb.make_brief_pattern` (which imports jax); a test
    holds the two equal."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits * 2, 2))
    r = np.linalg.norm(pts, axis=1)
    scale = np.minimum(1.0, _PATTERN_RADIUS / np.maximum(r, 1e-9))
    pts = pts * scale[:, None]
    return pts.reshape(n_bits, 4).astype(np.float32)


class FrameFeatures(NamedTuple):
    """Static-shape per-frame feature set."""

    xy: torch.Tensor        # [S, 2] float32, level-0 pixel coords (distorted/raw)
    response: torch.Tensor  # [S] float32
    angle: torch.Tensor     # [S] float32 radians
    octave: torch.Tensor    # [S] int32 pyramid level
    desc: torch.Tensor      # [S, 8] int32 packed 256-bit descriptors
    valid: torch.Tensor     # [S] bool


def _scan_depth(n_keep: int, n_cells: int, cell_size: int) -> int:
    """Per-cell scan depth R: covers the budget even if only half the
    cells contain corners."""
    return int(min(max(2, 2 * -(-n_keep // max(n_cells, 1)) + 1), cell_size * cell_size))


def select_uniform(
    score: torch.Tensor,
    strong: torch.Tensor,
    n_keep: int,
    cell_size: int,
    n_scan: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick `n_keep` spatially uniform keypoints from each of a batch of
    dense score maps [B, H, W].

    Priority = score + 1e6 for high-threshold corners, so retry-threshold
    corners are used only where no strong corner exists. Selection order
    is (rank within cell, -priority): every cell's best corner is taken
    before any cell's second best.

    Returns (xy [B, n_keep, 2] float32, response [B, n_keep],
    valid [B, n_keep] bool)."""
    B, H, W = score.shape
    dev = score.device
    prio_map = torch.where(strong, score + 1e6, score)
    ncy = (H + cell_size - 1) // cell_size
    ncx = (W + cell_size - 1) // cell_size
    n_cells = ncy * ncx
    padded = torch.full((B, ncy * cell_size, ncx * cell_size), -float("inf"), device=dev)
    padded[:, :H, :W] = prio_map
    cells = (
        padded.reshape(B, ncy, cell_size, ncx, cell_size)
        .permute(0, 1, 3, 2, 4)
        .reshape(B, n_cells, cell_size * cell_size)
    )
    # per-cell top-R by iterated masked max
    R = n_scan if n_scan is not None else _scan_depth(n_keep, n_cells, cell_size)
    prios, within = [], []
    for _ in range(R):
        am = torch.argmax(cells, dim=2, keepdim=True)
        prios.append(torch.gather(cells, 2, am)[..., 0])
        within.append(am[..., 0])
        cells = cells.scatter(2, am, -float("inf"))
    prio = torch.cat(prios, dim=1)                 # [B, n_cells * R]
    within = torch.cat(within, dim=1)
    rank = torch.arange(R, dtype=torch.float32, device=dev).repeat_interleave(n_cells)
    cid = torch.arange(n_cells, device=dev).repeat(R)
    valid = torch.isfinite(prio)
    ys = (cid // ncx) * cell_size + within // cell_size
    xs = (cid % ncx) * cell_size + within % cell_size
    # ascending rank, then descending priority; invalid last
    key = rank * 1e7 - torch.clamp(prio, max=9e6)
    key = torch.where(valid, key, float("inf"))
    sel = torch.sort(key, dim=1, stable=True).indices[:, :n_keep]
    ys_s = torch.gather(ys, 1, sel)
    xs_s = torch.gather(xs, 1, sel)
    valid_s = torch.gather(valid, 1, sel)
    prio_s = torch.gather(prio, 1, sel)
    bidx = torch.arange(B, device=dev)[:, None]
    strong_s = strong[bidx, ys_s, xs_s]
    resp = torch.where(valid_s, prio_s - torch.where(strong_s, 1e6, 0.0), 0.0)
    xy = torch.stack([xs_s, ys_s], dim=-1).to(torch.float32)
    return xy, resp, valid_s


def brief_from_patches(
    pt: torch.Tensor, angle: torch.Tensor, pattern: torch.Tensor, half: int = 16
) -> torch.Tensor:
    """Steered-BRIEF descriptors from blurred patches [N, S, S]: rotate
    the 256 sample pairs by each keypoint's angle, round to the nearest
    pixel (half to even), compare the two samples, pack the bits."""
    ca, sa = torch.cos(angle), torch.sin(angle)  # [N]

    def rotate(p):  # [256, 2] x [N] -> [N, 256, 2]
        x = p[None, :, 0] * ca[:, None] - p[None, :, 1] * sa[:, None]
        y = p[None, :, 0] * sa[:, None] + p[None, :, 1] * ca[:, None]
        return torch.stack([x, y], dim=-1)

    r1 = torch.round(rotate(pattern[:, 0:2])).to(torch.int64) + half
    r2 = torch.round(rotate(pattern[:, 2:4])).to(torch.int64) + half
    size = 2 * half + 1
    flat = pt.reshape(pt.shape[0], size * size)
    v1 = torch.gather(flat, 1, r1[..., 1] * size + r1[..., 0])  # [N, 256]
    v2 = torch.gather(flat, 1, r2[..., 1] * size + r2[..., 0])
    return _pack_bits(v2 > v1)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32, bit j of word w = bits[:, 32 w + j]."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(bits.shape[0], 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


class OrbExtractor(nn.Module):
    """Full ORB extraction on one grayscale image [H, W] float32 (0..255).

    Holds the BRIEF pattern and the blur taps as buffers; move it to the
    session's device with `.to(device)`."""

    def __init__(self, orb: OrbConfig):
        super().__init__()
        self.orb = orb
        self.register_buffer("pattern", torch.from_numpy(make_brief_pattern()))
        self.register_buffer("blur_taps", pyramid.gaussian_kernel_1d())

    @profiling.spanned("frame.build.extract")
    def forward(self, image: torch.Tensor) -> FrameFeatures:
        orb = self.orb
        dev = image.device
        if orb.normalize_exposure:
            image = image * (120.0 / torch.clamp(torch.mean(image), min=1.0))
        levels = pyramid.build_pyramid(image, orb)
        budgets = pyramid.feature_budgets(orb)
        scales = pyramid.level_scales(orb)
        L = orb.num_levels
        shapes = [tuple(lv.shape) for lv in levels]
        cs = orb.cell_size

        # stage 1: FAST + uniform selection. Level 0 at native resolution;
        # levels 1..L-1 stacked on a level-1-sized canvas as one batch
        xs_loc, xs, resps, octaves, valids = [], [], [], [], []
        if budgets[0] > 0:
            score0, strong0 = fast.detect(
                levels[0], orb.ini_th_fast, orb.min_th_fast, orb.edge_threshold
            )
            xy0, resp0, valid0 = select_uniform(score0[None], strong0[None], budgets[0], cs)
            xs_loc.append(xy0[0])
            xs.append(xy0[0] * scales[0])
            resps.append(resp0[0])
            octaves.append(torch.zeros(budgets[0], dtype=torch.int32, device=dev))
            valids.append(valid0[0])

        hi_levels = [lvl for lvl in range(1, L) if budgets[lvl] > 0]
        stack = None
        if L > 1:
            H1, W1 = shapes[1]
            stack = torch.stack(
                [
                    F.pad(levels[lvl], (0, W1 - shapes[lvl][1], 0, H1 - shapes[lvl][0]))
                    for lvl in range(1, L)
                ]
            )
        if hi_levels:
            sub = [lvl - 1 for lvl in hi_levels]
            scoreS, strongS = fast.detect_stack(
                stack[sub] if len(sub) < L - 1 else stack,
                tuple(shapes[lvl] for lvl in hi_levels),
                orb.ini_th_fast, orb.min_th_fast, orb.edge_threshold,
            )

            def cells_of(shape):
                return ((shape[0] + cs - 1) // cs) * ((shape[1] + cs - 1) // cs)

            # one scan depth / top-k for the batch, from each level's REAL
            # cell count (the canvas has more, always-empty cells)
            R = max(_scan_depth(budgets[lvl], cells_of(shapes[lvl]), cs) for lvl in hi_levels)
            kmax = max(budgets[lvl] for lvl in hi_levels)
            xyS, respS, validS = select_uniform(scoreS, strongS, kmax, cs, n_scan=R)
            # selection is sorted by (cell rank, -priority), so the first
            # budget[lvl] rows are what a per-level top-k would return
            for i, lvl in enumerate(hi_levels):
                b = budgets[lvl]
                xs_loc.append(xyS[i, :b])
                xs.append(xyS[i, :b] * scales[lvl])
                resps.append(respS[i, :b])
                octaves.append(torch.full((b,), lvl, dtype=torch.int32, device=dev))
                valids.append(validS[i, :b])

        xy_loc = torch.cat(xs_loc)
        xy = torch.cat(xs)
        resp = torch.cat(resps)
        octave = torch.cat(octaves)
        valid = torch.cat(valids)

        # stage 2: orientation + descriptors for all levels in one batch.
        # Raw (IC angle) and blurred (BRIEF) images are the two channels of
        # one [L, Hp, Wp, 2] canvas, each level padded by half_br; the FAST
        # edge border keeps every patch inside its own level
        half_ic = orb.half_patch
        half_br = 16
        H0, W0 = shapes[0]
        Hp, Wp = H0 + 2 * half_br, W0 + 2 * half_br
        pair0 = F.pad(
            torch.stack([levels[0], pyramid.gaussian_blur(levels[0], self.blur_taps)], dim=-1),
            (0, 0, half_br, half_br, half_br, half_br),
        )
        if L > 1:
            H1, W1 = shapes[1]
            blurS = pyramid.gaussian_blur(stack, self.blur_taps)
            pairS = F.pad(
                torch.stack([stack, blurS], dim=-1),
                (0, 0, half_br, Wp - half_br - W1, half_br, Hp - half_br - H1),
            )
            canvas = torch.cat([pair0[None], pairS])
        else:
            canvas = pair0[None]
        both = patches.gather_patches_stack_mc(canvas, octave, xy_loc, half_br)
        crop = half_br - half_ic
        angle = patches.ic_angle(
            both[:, crop: crop + 2 * half_ic + 1, crop: crop + 2 * half_ic + 1, 0], half_ic
        )
        desc = brief_from_patches(both[..., 1], angle, self.pattern, half_br)

        S = orb.feature_slots
        pad = S - xy.shape[0]
        if pad < 0:
            raise ValueError(f"feature budget {xy.shape[0]} exceeds feature_slots {S}")
        if pad:
            xy = F.pad(xy, (0, 0, 0, pad))
            resp = F.pad(resp, (0, pad))
            angle = F.pad(angle, (0, pad))
            octave = F.pad(octave, (0, pad))
            desc = F.pad(desc, (0, 0, 0, pad))
            valid = F.pad(valid, (0, pad))
        return FrameFeatures(xy=xy, response=resp, angle=angle, octave=octave,
                             desc=desc, valid=valid)
