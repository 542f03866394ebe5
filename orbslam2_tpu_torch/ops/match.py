"""Descriptor matching: dense gated Hamming matching with ratio tests,
rotation-consistency filtering and projection-guided search.

Port of the parts of `orbslam2_tpu.ops.match` the RGB-D tracking path
calls. Every matcher computes the full [A, B] distance matrix (kernel K1)
and expresses each pruning rule as a mask on it; results are per-A best
candidates plus a per-B assignment with conflicts resolved by minimum
distance, then lowest A index. Constants follow ORB-SLAM2: TH_HIGH=100,
TH_LOW=50, HISTO_LENGTH=30.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orbslam2_tpu_torch.ops import cuda_hamming

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
_BIG = 1 << 20


class MatchResult(NamedTuple):
    best_idx: torch.Tensor   # [A] int32 index into B, -1 if no match
    best_dist: torch.Tensor  # [A] int32
    assigned: torch.Tensor   # [B] int32 index into A, -1 if none

    @property
    def num_matches(self) -> torch.Tensor:
        return torch.sum(self.best_idx >= 0)


def _masked_best2(dist: torch.Tensor, gate: torch.Tensor):
    """Per-row best and second best over a gated distance matrix.
    dist [A, B] int32, gate [A, B] bool -> (best_idx, best, second); ties
    take the first index."""
    d = torch.where(gate, dist, _BIG)
    best = torch.amin(d, dim=1)
    best_idx = torch.argmin(d, dim=1)
    d2 = d.scatter(1, best_idx[:, None], _BIG)
    second = torch.amin(d2, dim=1)
    return best_idx.to(torch.int32), best, second


def _resolve_conflicts(best_idx: torch.Tensor, best_dist: torch.Tensor, ok: torch.Tensor, n_b: int):
    """Keep only the lowest-distance A for each B, then the lowest A index
    among equal distances. Returns (kept_ok [A] bool, assigned [B] int32)."""
    dev = best_idx.device
    tgt = torch.where(ok, best_idx, n_b).to(torch.int64)  # invalid -> scratch slot
    min_per_b = torch.full((n_b + 1,), _BIG, dtype=torch.int32, device=dev).scatter_reduce(
        0, tgt, torch.where(ok, best_dist, _BIG).to(torch.int32), "amin", include_self=True
    )
    kept = ok & (best_dist == min_per_b[tgt])
    a_ids = torch.arange(best_idx.shape[0], dtype=torch.int32, device=dev)
    min_a = torch.full((n_b + 1,), 1 << 30, dtype=torch.int32, device=dev).scatter_reduce(
        0, tgt, torch.where(kept, a_ids, 1 << 30), "amin", include_self=True
    )
    kept = kept & (a_ids == min_a[tgt])
    assigned = torch.full((n_b + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, tgt, torch.where(kept, a_ids, -1), "amax", include_self=True
    )[:n_b]
    return kept, assigned


def rotation_consistency_mask(
    angle_a: torch.Tensor, angle_b: torch.Tensor, best_idx: torch.Tensor, ok: torch.Tensor
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (ORB-SLAM2 ComputeThreeMaxima); bins 2 and 3 are
    dropped when below 0.1x bin 1. Top-3 ties take the lower bin."""
    two_pi = 2.0 * math.pi
    diff = angle_a - angle_b[torch.clamp(best_idx, 0, angle_b.shape[0] - 1).to(torch.int64)]
    diff = torch.remainder(diff, two_pi)
    bins = torch.clamp((diff * (HISTO_LENGTH / two_pi)).to(torch.int64), 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=ok.device).index_add(
        0, bins, ok.to(torch.int32)
    )
    top_vals, top_idx = torch.sort(hist, descending=True, stable=True)
    admit2 = torch.where(top_vals[1] > 0.1 * top_vals[0], top_idx[1], -1)
    admit3 = torch.where(top_vals[2] > 0.1 * top_vals[0], top_idx[2], -1)
    keep_bin = (bins == top_idx[0]) | (bins == admit2) | (bins == admit3)
    return ok & keep_bin


def match_gated(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    gate: torch.Tensor,
    max_dist=TH_LOW,
    ratio: float = 1.0,
    angle_a: torch.Tensor | None = None,
    angle_b: torch.Tensor | None = None,
    check_rotation: bool = False,
) -> MatchResult:
    """Generic dense matcher: full Hamming matrix (K1) + gate mask + ratio
    test (+ optional rotation-consistency filter)."""
    dist = cuda_hamming.distance_matrix(desc_a, desc_b)
    best_idx, best, second = _masked_best2(dist, gate)
    ok = best <= max_dist
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32) <= ratio * second.to(torch.float32))
    if check_rotation:
        ok = rotation_consistency_mask(angle_a, angle_b, best_idx, ok)
    kept, assigned = _resolve_conflicts(best_idx, best, ok, desc_b.shape[0])
    return MatchResult(
        best_idx=torch.where(kept, best_idx, -1),
        best_dist=torch.where(kept, best, _BIG),
        assigned=assigned,
    )


def radius_gate(
    pred_uv: torch.Tensor,
    feat_xy: torch.Tensor,
    radius: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
) -> torch.Tensor:
    """[A, B] mask: feature b within `radius[a]` pixels of projection a."""
    d = pred_uv[:, None, :] - feat_xy[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    return (r2 <= (radius[:, None] ** 2)) & valid_a[:, None] & valid_b[None, :]


def octave_gate(pred_octave: torch.Tensor, feat_octave: torch.Tensor, lo: int = -1, hi: int = 1):
    """[A, B] mask: feature octave within [pred+lo, pred+hi]."""
    d = feat_octave[None, :] - pred_octave[:, None]
    return (d >= lo) & (d <= hi)


def search_by_projection(
    point_desc, point_uv, point_octave, point_valid,
    feat_desc, feat_xy, feat_octave, feat_valid,
    radius, max_dist=TH_HIGH, ratio: float = 0.8,
) -> MatchResult:
    """Project map points into a frame and match within per-point radii
    and a scale band, with a best/second ratio test."""
    gate = radius_gate(point_uv, feat_xy, radius, point_valid, feat_valid)
    gate = gate & octave_gate(point_octave, feat_octave)
    return match_gated(point_desc, feat_desc, gate, max_dist=max_dist, ratio=ratio)


def search_frame_to_frame(
    prev_desc, prev_uv_pred, prev_octave, prev_valid, prev_angle,
    feat_desc, feat_xy, feat_octave, feat_valid, feat_angle,
    radius, check_rotation: bool = True, max_dist=TH_HIGH,
) -> MatchResult:
    """Motion-model search: last frame's points projected into the
    current frame (scale-gated radius, ratio 0.9, rotation histogram)."""
    gate = radius_gate(prev_uv_pred, feat_xy, radius, prev_valid, feat_valid)
    gate = gate & octave_gate(prev_octave, feat_octave)
    return match_gated(
        prev_desc, feat_desc, gate, max_dist=max_dist, ratio=0.9,
        angle_a=prev_angle, angle_b=feat_angle, check_rotation=check_rotation,
    )


def search_brute(
    desc_a, valid_a, angle_a, desc_b, valid_b, angle_b,
    max_dist=TH_LOW, ratio: float = 0.75, check_rotation: bool = True,
) -> MatchResult:
    """Unconstrained dense matcher, the substitute for SearchByBoW: the
    full matrix plus ratio test and rotation filter."""
    gate = valid_a[:, None] & valid_b[None, :]
    return match_gated(
        desc_a, desc_b, gate, max_dist=max_dist, ratio=ratio,
        angle_a=angle_a, angle_b=angle_b, check_rotation=check_rotation,
    )
