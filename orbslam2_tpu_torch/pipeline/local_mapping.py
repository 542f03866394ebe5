"""Local mapping: new-point triangulation, point culling, duplicate fusion,
local bundle adjustment and keyframe culling.

Port of `orbslam2_tpu.pipeline.local_mapping` (ORB-SLAM2 LocalMapping:
MapPointCulling, CreateNewMapPoints, SearchInNeighbors,
LocalBundleAdjustment, KeyFrameCulling): the stages the fused keyframe
step calls, and the unfused iteration (`LocalMapper.process_keyframe`,
`post_keyframe`) that runs them one host-driven call at a time. Every function
updates the `MapState` it is given in place, where the reference returns a
new pytree and donates the old one.

Keyframe ids may be Python ints or one-element tensors chosen on the card
(`map_state.kf_index`), so a loop over neighbours or fuse targets never
reads an id back to the host. Scatters with a skip mask go through
`map_state.masked_put_`, the counterpart of the reference's
``.at[i].set(..., mode="drop")``.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_tpu_torch.config import SlamConfig
from orbslam2_tpu_torch.geometry import camera as cam_geo
from orbslam2_tpu_torch.geometry import se3, triangulate
from orbslam2_tpu_torch.ops import match
from orbslam2_tpu_torch.pipeline.tracking import _i64, _top_k
from orbslam2_tpu_torch.slam_map import map_state as ms
from orbslam2_tpu_torch.slam_map.map_state import kf_index, masked_put_
from orbslam2_tpu_torch.solvers import ba


def _numpy(x) -> np.ndarray:
    """A host array of a tensor (on any device) or an array-like."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _row(arr: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """arr[k] for a [1] index tensor: a copy, so later in-place writes to
    the state do not show through (a row of a JAX array is a copy too)."""
    return arr[k][0]


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def fundamental_from_poses(Tcw1, Tcw2, K: cam_geo.Intrinsics) -> torch.Tensor:
    """F12 = K^-T [t12]x R12 K^-1 with T12 = T1 T2^-1 (ORB-SLAM2
    LocalMapping::ComputeF12)."""
    T12 = Tcw1 @ se3.inverse(Tcw2)
    Kinv = torch.linalg.inv_ex(K.K).inverse
    return Kinv.T @ se3.hat(T12[:3, 3]) @ T12[:3, :3] @ Kinv


# ---------------------------------------------------------------------------
# binding / unbinding primitives
# ---------------------------------------------------------------------------


def bind_points_to_kf(state: ms.MapState, kf_id, feat_idx, point_ids, mask) -> None:
    """Bind existing points to features of a keyframe: set kf_point_idx,
    append to the observation tables, bump n_obs.

    One candidate per feature slot, the first in order: with duplicate
    slots the binding would keep one point while both got observation
    entries (the reference arbitrates the same way)."""
    S_cap = state.kf_point_idx.shape[1]
    dev = point_ids.device
    k = kf_index(kf_id, dev)
    ok = mask & (point_ids >= 0) & (feat_idx >= 0)
    feat_w = _i64(torch.where(ok, feat_idx, S_cap))
    n_in = point_ids.shape[0]
    order = torch.arange(n_in, device=dev)
    first = torch.full((S_cap + 1,), n_in, dtype=torch.int64, device=dev).scatter_reduce(
        0, feat_w, order, "amin", include_self=True
    )
    ok = ok & (first[feat_w] == order)
    masked_put_(state.kf_point_idx, (k, feat_idx), point_ids, ok)
    pid = _i64(torch.where(ok, point_ids, 0))
    rows = state.mp_obs_kf[pid]
    already = torch.any(rows == k, dim=1)   # this keyframe observes it already
    free = rows < 0
    slot = torch.argmax(free.to(torch.int32), dim=1)
    do = ok & torch.any(free, dim=1) & ~already
    masked_put_(state.mp_obs_kf, (pid, slot), k, do)
    masked_put_(state.mp_obs_feat, (pid, slot), feat_idx, do)
    ur = state.kf_ur[k, _i64(torch.clamp(feat_idx, 0, S_cap - 1))]
    masked_put_(state.mp_n_obs, pid, torch.where(ur >= 0, 2, 1), do, accumulate=True)


def erase_observations(state: ms.MapState, point_ids, kf_ids, mask) -> None:
    """Remove the observations (point, kf): clear the obs slot, unbind the
    feature, decrement n_obs (ORB-SLAM2 MapPoint::EraseObservation)."""
    K = state.capacity_kf
    S_cap = state.kf_point_idx.shape[1]
    kf_ids = _i64(kf_ids)
    pid = _i64(torch.where(mask, point_ids, 0))
    rows = state.mp_obs_kf[pid]              # [N, O]
    hit = rows == kf_ids[:, None]
    slot = torch.argmax(hit.to(torch.int32), dim=1)
    found = torch.any(hit, dim=1) & mask
    feat = _i64(state.mp_obs_feat[pid, slot])
    masked_put_(state.mp_obs_kf, (pid, slot), -1, found)
    masked_put_(state.mp_obs_feat, (pid, slot), -1, found)
    masked_put_(state.kf_point_idx, (kf_ids, feat), -1, found)
    ur = state.kf_ur[torch.clamp(kf_ids, 0, K - 1), torch.clamp(feat, 0, S_cap - 1)]
    masked_put_(state.mp_n_obs, pid, torch.where(ur >= 0, -2, -1), found, accumulate=True)


def invalidate_points(state: ms.MapState, point_ids, mask) -> None:
    """SetBadFlag for a batch of points: clear validity and all bindings
    (ORB-SLAM2 MapPoint::SetBadFlag).

    The keyframe binding tables are scrubbed globally, every kf_point_idx
    entry that names a now-invalid point, not through the observation
    table: bindings past `obs_slots` have no observation entry, and once
    the slot is recycled they would name a different point."""
    P = state.capacity_mp
    sel = mask & (point_ids >= 0) & (point_ids < P)
    pid = _i64(point_ids)
    masked_put_(state.mp_valid, pid, False, sel)
    masked_put_(state.mp_obs_kf, pid, -1, sel)
    masked_put_(state.mp_obs_feat, pid, -1, sel)
    masked_put_(state.mp_n_obs, pid, 0, sel)
    kpi = state.kf_point_idx
    live = (kpi >= 0) & state.mp_valid[_i64(torch.clamp(kpi, 0, P - 1))]
    kpi.masked_fill_(~live, -1)


# ---------------------------------------------------------------------------
# map point culling (ORB-SLAM2 LocalMapping::MapPointCulling)
# ---------------------------------------------------------------------------


def cull_points(state: ms.MapState, point_ids, current_kf) -> torch.Tensor:
    """The recent-point test over a probation window. Culled points are
    invalidated; points that survive 3 keyframes graduate. Returns
    keep [W] bool: still on probation.

    `current_kf` is the current keyframe's seq number (mp_first_kf holds
    the creating keyframe's seq; slot ids are recycled)."""
    pid = _i64(torch.clamp(point_ids, 0, state.capacity_mp - 1))
    valid = (point_ids >= 0) & state.mp_valid[pid]
    found_ratio = state.mp_found[pid].to(torch.float32) / torch.clamp(
        state.mp_visible[pid].to(torch.float32), min=1.0
    )
    age = current_kf - state.mp_first_kf[pid]
    # stereo-seeded points need 3 observations by age 2
    bad = valid & ((found_ratio < 0.25) | ((age >= 2) & (state.mp_n_obs[pid] <= 3)))
    graduate = valid & (age >= 3) & ~bad
    invalidate_points(state, pid, bad)
    return valid & ~bad & ~graduate


def ensure_free_slots(state: ms.MapState, current_kf, headroom: int, protect=None,
                      min_age: int = 24, anchor_obs_kfs: int = 3) -> None:
    """Keep at least `headroom` free point slots by invalidating the most
    expendable points, in tiers so that a full pool never deadlocks:
    tier 0, mature weakly observed points, go first; tier 1, young points
    (the triangulation frontier), next; tier 2, anchors observed by
    >= `anchor_obs_kfs` live keyframes, last. Within a tier the lowest
    n_obs + found ratio goes first, ties in slot order. `protect`-ed points
    are never touched."""
    n_free = torch.sum(~state.mp_valid)
    age = current_kf - state.mp_first_kf
    okf = _i64(torch.clamp(state.mp_obs_kf, 0, state.capacity_kf - 1))
    obs_live = (state.mp_obs_kf >= 0) & state.kf_valid[okf]
    anchor = torch.sum(obs_live, dim=1) >= anchor_obs_kfs
    frontier = age < min_age
    tier = torch.where(anchor, 2, torch.where(frontier, 1, 0)).to(torch.float32)
    candidate = state.mp_valid if protect is None else state.mp_valid & ~protect
    fr = state.mp_found.to(torch.float32) / torch.clamp(state.mp_visible.to(torch.float32), min=1.0)
    # higher score = more worth keeping; non-candidates are never selected
    score = tier * 1e4 + state.mp_n_obs.to(torch.float32) + fr
    score = torch.where(candidate, score, torch.inf)
    vals, ids = _top_k(-score, headroom)          # weakest first
    n_kill = torch.clamp(headroom - n_free, 0, headroom)
    kill = (torch.arange(headroom, device=ids.device) < n_kill) & torch.isfinite(vals)
    invalidate_points(state, ids, kill)


# ---------------------------------------------------------------------------
# new point creation (ORB-SLAM2 LocalMapping::CreateNewMapPoints)
# ---------------------------------------------------------------------------


def triangulate_pair(
    state: ms.MapState,
    kf1,
    kf2,
    K: cam_geo.Intrinsics,
    scale_factors,
    level_sigma2,
    bf_over_fx,
    num_levels: int = 8,
):
    """Epipolar-match the unbound features of kf1 against kf2 and
    triangulate them.

    Returns, aligned with kf1's feature slots: f2 [S] (kf2 slot or -1),
    pw [S, 3], ok [S] bool and dist1 [S] (distance to kf1's centre).
    `bf_over_fx` is unused, as in the reference."""
    dev = state.kf_Tcw.device
    k1, k2 = kf_index(kf1, dev), kf_index(kf2, dev)
    T1, T2 = _row(state.kf_Tcw, k1), _row(state.kf_Tcw, k2)
    F12 = fundamental_from_poses(T1, T2, K)
    c1 = se3.camera_center(T1)
    c2 = se3.camera_center(T2)
    baseline = torch.linalg.norm(c2 - c1)

    xy1, xy2 = _row(state.kf_xy, k1), _row(state.kf_xy, k2)
    oct1, oct2 = _row(state.kf_octave, k1), _row(state.kf_octave, k2)
    unbound1 = _row(state.kf_feat_valid, k1) & (_row(state.kf_point_idx, k1) < 0)
    unbound2 = _row(state.kf_feat_valid, k2) & (_row(state.kf_point_idx, k2) < 0)
    # epipole of camera 1's centre in image 2
    epipole2 = cam_geo.project(se3.apply(T2, c1)[None], K)[0]

    res = match.search_for_triangulation(
        _row(state.kf_desc, k1), xy1, oct1, unbound1, _row(state.kf_angle, k1),
        _row(state.kf_desc, k2), xy2, oct2, unbound2, _row(state.kf_angle, k2),
        F12, epipole2, level_sigma2,
    )
    f2 = res.best_idx
    matched = f2 >= 0
    f2c = _i64(torch.clamp(f2, 0, xy2.shape[0] - 1))

    uv1 = xy1
    uv2 = xy2[f2c]
    pw = triangulate.triangulate_two_view(uv1, uv2, T1, T2, K)

    # low parallax: fall back to a keyframe's depth
    cosp = triangulate.parallax_cos(pw, c1, c2)
    d1 = _row(state.kf_depth, k1)
    d2 = _row(state.kf_depth, k2)[f2c]
    has_stereo1 = d1 > 0
    has_stereo2 = d2 > 0
    low_parallax = cosp > 0.9998
    pw_s1 = se3.apply(se3.inverse(T1), cam_geo.backproject(uv1, d1, K))
    pw_s2 = se3.apply(se3.inverse(T2), cam_geo.backproject(uv2, d2, K))
    pw = torch.where(
        (low_parallax & has_stereo1)[:, None], pw_s1,
        torch.where((low_parallax & has_stereo2)[:, None], pw_s2, pw),
    )
    usable = matched & (~low_parallax | has_stereo1 | has_stereo2) & (cosp > 0) & (cosp < 0.99995)

    # cheirality + reprojection chi2 in both views
    pc1 = se3.apply(T1, pw)
    pc2 = se3.apply(T2, pw)
    z_ok = (pc1[:, 2] > 1e-3) & (pc2[:, 2] > 1e-3)
    pr1 = cam_geo.project(pc1, K)
    pr2 = cam_geo.project(pc2, K)
    lvl1 = _i64(torch.clamp(oct1, 0, num_levels - 1))
    lvl2 = _i64(torch.clamp(oct2[f2c], 0, num_levels - 1))
    e1 = torch.sum((pr1 - uv1) ** 2, -1)
    e2 = torch.sum((pr2 - uv2) ** 2, -1)
    chi_ok = (e1 <= 5.991 * level_sigma2[lvl1]) & (e2 <= 5.991 * level_sigma2[lvl2])

    # scale consistency
    dist1 = torch.linalg.norm(pw - c1, dim=-1)
    dist2 = torch.linalg.norm(pw - c2, dim=-1)
    ratio_d = dist2 / torch.clamp(dist1, min=1e-9)
    ratio_o = scale_factors[lvl2] / scale_factors[lvl1]
    factor = 1.5 * 1.2
    scale_ok = (ratio_d < ratio_o * factor) & (ratio_d * factor > ratio_o)

    ok = usable & z_ok & chi_ok & scale_ok & (baseline > 0.01)
    return f2, pw, ok, dist1


def create_new_points(cfg: SlamConfig, state: ms.MapState, kf_id: int, K, scale_factors,
                      level_sigma2, neighbor_ids) -> torch.Tensor:
    """Triangulate kf_id against each covisible neighbour in turn and insert
    the new points, in place (ORB-SLAM2 CreateNewMapPoints; the unfused
    path). A host loop over the neighbours: each pair reads back whether
    anything triangulated, as the reference does, and features an earlier
    neighbour already bound are left out. Returns the new point ids."""
    nl = cfg.orb.num_levels
    S = state.kf_point_idx.shape[1]
    cols = torch.arange(S, dtype=torch.int32, device=state.kf_Tcw.device)
    created = []
    for nkf in neighbor_ids:
        f2, pw, ok, dist1 = triangulate_pair(state, kf_id, int(nkf), K, scale_factors,
                                             level_sigma2, cfg.camera.baseline, num_levels=nl)
        if not bool(torch.any(ok)):
            continue
        ok = ok & (state.kf_point_idx[kf_id] < 0)
        max_d = dist1 * scale_factors[_i64(torch.clamp(state.kf_octave[kf_id], 0, nl - 1))]
        min_d = max_d / float(cfg.orb.scale_factor ** (nl - 1))
        rays = pw - se3.camera_center(state.kf_Tcw[kf_id])
        normal = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=1e-9)
        pids = ms.add_points(state, pw, ok, kf_id, cols, state.kf_desc[kf_id].clone(), normal,
                             min_d, max_d, state.kf_ur[kf_id].clone())
        # the second view
        bind_points_to_kf(state, int(nkf), f2, pids, pids >= 0)
        created.append(pids)
    if not created:
        return torch.zeros(0, dtype=torch.int32, device=cols.device)
    allp = torch.cat(created)
    return allp[allp >= 0]


# ---------------------------------------------------------------------------
# fuse (ORB-SLAM2 SearchInNeighbors and ORBmatcher::Fuse)
# ---------------------------------------------------------------------------


def fuse_match(
    state: ms.MapState,
    point_ids,
    point_mask,
    target_kf,
    K: cam_geo.Intrinsics,
    scale_factors,
    image_bounds,
    num_levels: int = 8,
) -> torch.Tensor:
    """Read-only half of Fuse: project candidate points [M] into target_kf
    and match them to its features. Returns feat [M] (slot or -1)."""
    t = kf_index(target_kf, point_ids.device)
    Tcw = _row(state.kf_Tcw, t)
    pid = _i64(torch.clamp(point_ids, 0, state.capacity_mp - 1))
    pvalid = point_mask & (point_ids >= 0) & state.mp_valid[pid]
    # points the target already observes are skipped
    pvalid = pvalid & ~torch.any(state.mp_obs_kf[pid] == t, dim=1)

    pw = state.mp_pos[pid]
    pc = se3.apply(Tcw, pw)
    uv = cam_geo.project(pc, K)
    xmin, xmax, ymin, ymax = image_bounds
    rays = pw - se3.camera_center(Tcw)
    dist = torch.linalg.norm(rays, dim=-1)
    viewcos = torch.sum(rays * state.mp_normal[pid], -1) / torch.clamp(dist, min=1e-9)
    vis = (
        pvalid & (pc[:, 2] > 0.05)
        & (uv[:, 0] >= xmin) & (uv[:, 0] < xmax)
        & (uv[:, 1] >= ymin) & (uv[:, 1] < ymax)
        & (dist >= 0.8 * state.mp_min_dist[pid])
        & (dist <= 1.2 * state.mp_max_dist[pid])
        & (viewcos > 0.5)
    )
    ratio = state.mp_max_dist[pid] / torch.clamp(dist, min=1e-9)
    pred_oct = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / torch.log(scale_factors[1])).to(torch.int32),
        0, num_levels - 1,
    )
    radius = 3.0 * scale_factors[_i64(pred_oct)]
    res = match.search_by_projection(
        state.mp_desc[pid], uv, pred_oct, vis,
        _row(state.kf_desc, t), _row(state.kf_xy, t),
        _row(state.kf_octave, t), _row(state.kf_feat_valid, t),
        radius, max_dist=match.TH_LOW, ratio=1.0,
    )
    return res.best_idx


def fuse_apply(state: ms.MapState, point_ids, feat, target_kf) -> None:
    """Writing half of Fuse: bind free slots; where a slot holds another
    point, keep the better-observed one and kill a loser left with fewer
    than 2 observations. The decisions read the current state, not the
    one the match saw."""
    P = state.capacity_mp
    t = kf_index(target_kf, point_ids.device)
    pid = _i64(torch.clamp(point_ids, 0, P - 1))
    matched = (feat >= 0) & (point_ids >= 0) & state.mp_valid[pid]
    # another fuse into the same target may have bound this point meanwhile
    matched = matched & ~torch.any(state.mp_obs_kf[pid] == t, dim=1)
    featc = _i64(torch.clamp(feat, 0, state.kf_point_idx.shape[1] - 1))
    existing = state.kf_point_idx[t, featc]             # a copy

    # case A: free slot -> bind
    bind_points_to_kf(state, t, feat, point_ids, matched & (existing < 0))

    # case B: the slot holds another point -> the better-observed one stays
    other = _i64(torch.clamp(existing, 0, P - 1))
    conflict = matched & (existing >= 0) & (existing != point_ids) & state.mp_valid[other]
    win = conflict & (state.mp_n_obs[pid] > state.mp_n_obs[other])
    erase_observations(state, other, t.expand_as(other), win)
    bind_points_to_kf(state, t, feat, point_ids, win)
    invalidate_points(state, other, win & (state.mp_n_obs[other] < 2))


def fuse_points_into_kf(
    state: ms.MapState,
    point_ids,
    point_mask,
    target_kf,
    K: cam_geo.Intrinsics,
    scale_factors,
    image_bounds,
    num_levels: int = 8,
) -> None:
    """Project points into target_kf and fuse them (ORB-SLAM2
    ORBmatcher::Fuse): match, then apply."""
    feat = fuse_match(state, point_ids, point_mask, target_kf, K, scale_factors,
                      image_bounds, num_levels=num_levels)
    fuse_apply(state, point_ids, feat, target_kf)


def fuse_points_into_kfs(
    state: ms.MapState,
    point_ids,
    point_mask,
    targets,
    target_ok,
    K: cam_geo.Intrinsics,
    scale_factors,
    image_bounds,
    num_levels: int = 8,
) -> None:
    """SearchAndFuse over many target keyframes [T]: every target's
    projection match runs against the state before any fuse (the
    reference's `vmap`), then the fuses apply one target after another, so
    each conflict is decided on the observation counts of the moment. A
    target whose `target_ok` is False fuses nothing."""
    feats = [fuse_match(state, point_ids, point_mask, targets[i], K, scale_factors,
                        image_bounds, num_levels=num_levels) for i in range(targets.shape[0])]
    for i, feat in enumerate(feats):
        fuse_apply(state, torch.where(target_ok[i], point_ids, -1), feat, targets[i])


# ---------------------------------------------------------------------------
# local BA assembly (ORB-SLAM2 Optimizer::LocalBundleAdjustment)
# ---------------------------------------------------------------------------


def build_local_ba_problem(
    state: ms.MapState,
    kf_id,
    inv_sigma2,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
):
    """Assemble a fixed-shape BAProblem around kf_id.

    Local cameras: kf_id and its covisible keyframes, strongest first.
    Points: those bound in the local cameras, the most relevant camera's
    first and the newest slot on ties, up to `max_points`. Fixed cameras:
    the other observers of those points. Keyframe slot 0 stays fixed
    (gauge). Returns (problem, cam_ids [C], cam_present [C], point_ids
    [Mp] (P where absent), point_ok [Mp])."""
    Kcap = state.capacity_kf
    P = state.capacity_mp
    dev = state.covis.device
    max_local = min(max_local, Kcap)
    max_fixed = min(max_fixed, Kcap)
    k = kf_index(kf_id, dev)
    w = _row(state.covis, k) * state.kf_valid
    w.index_fill_(0, k, 1 << 20)
    _, cam_local = _top_k(w, max_local)
    local_ok = w[cam_local] > 0
    is_local = torch.zeros(Kcap, dtype=torch.bool, device=dev)
    masked_put_(is_local, cam_local, True, local_ok)

    ids = state.kf_point_idx[cam_local]                  # [L, S]
    Lc = cam_local.shape[0]
    ids_w = _i64(torch.where(local_ok[:, None] & (ids >= 0), ids, P))
    rank_l = torch.arange(Lc, dtype=torch.int32, device=dev)[:, None].expand(ids_w.shape)
    pri = torch.full((P + 1,), Lc, dtype=torch.int32, device=dev).scatter_reduce(
        0, ids_w.reshape(-1), rank_l.reshape(-1), "amin", include_self=True
    )[:P]
    flagged = (pri < Lc) & state.mp_valid
    score_pt = torch.where(
        flagged, (Lc - pri) * (P + 1) + torch.arange(P, dtype=torch.int32, device=dev), -1
    )
    top_score, pts = _top_k(score_pt, max_points)
    pt_ok = top_score >= 0
    pts = torch.where(pt_ok, pts, P)
    ptsc = torch.clamp(pts, 0, P - 1)

    obs_kf = state.mp_obs_kf[ptsc][:, :obs_slots]       # [Mp, O]
    obs_ft = state.mp_obs_feat[ptsc][:, :obs_slots]
    obs_live = (obs_kf >= 0) & pt_ok[:, None]
    okf = _i64(torch.clamp(obs_kf, 0, Kcap - 1))

    fixed_candidate = torch.zeros(Kcap, dtype=torch.bool, device=dev)
    masked_put_(fixed_candidate, okf, True, obs_live)
    fixed_score = (fixed_candidate & ~is_local & state.kf_valid).to(torch.int32)
    _, cam_fixed = _top_k(fixed_score, max_fixed)     # 0/1 scores: ties in slot order
    fixed_ok = fixed_score[cam_fixed] > 0

    cam_ids = torch.cat([cam_local, cam_fixed])
    C = cam_ids.shape[0]
    cam_present = torch.cat([local_ok, fixed_ok])
    cam_free = torch.cat([local_ok, torch.zeros(max_fixed, dtype=torch.bool, device=dev)])
    cam_free = cam_free & (cam_ids != 0)

    lut = torch.full((Kcap,), -1, dtype=torch.int64, device=dev)
    masked_put_(lut, cam_ids, torch.arange(C, device=dev), cam_present)
    slot = lut[okf]
    obs_ok = obs_live & (slot >= 0)
    ftc = _i64(torch.clamp(obs_ft, 0, state.kf_xy.shape[1] - 1))
    octv = state.kf_octave[okf, ftc]
    prob = ba.BAProblem(
        cam_Tcw=state.kf_Tcw[cam_ids],
        cam_free=cam_free,
        points=state.mp_pos[ptsc],
        point_valid=pt_ok & state.mp_valid[ptsc],
        obs_cam=torch.clamp(slot, 0, C - 1),
        obs_uv=state.kf_xy[okf, ftc],
        obs_ur=torch.where(obs_ok, state.kf_ur[okf, ftc], -1.0),
        obs_inv_sigma2=inv_sigma2[_i64(torch.clamp(octv, 0, inv_sigma2.shape[0] - 1))],
        obs_valid=obs_ok,
    )
    return prob, cam_ids, cam_present, pts, pt_ok


def writeback_local_ba(state: ms.MapState, result: ba.BAResult, prob: ba.BAProblem,
                       cam_ids, cam_present, point_ids, point_ok) -> None:
    """Write the optimised free poses and points back into the map, erase
    the outlier observations and kill points left with fewer than 2."""
    masked_put_(state.kf_Tcw, cam_ids, result.cam_Tcw, cam_present & prob.cam_free)
    masked_put_(state.mp_pos, point_ids, result.points, point_ok)
    bad = prob.obs_valid & ~result.obs_inlier          # [Mp, O]
    Mp, O = bad.shape
    pids = point_ids[:, None].expand(Mp, O).reshape(-1)
    kfs = cam_ids[_i64(prob.obs_cam)].reshape(-1)
    erase_observations(state, pids, kfs, bad.reshape(-1))
    P = state.capacity_mp
    few = point_ok & (state.mp_n_obs[_i64(torch.clamp(point_ids, 0, P - 1))] < 2)
    invalidate_points(state, point_ids, few)


def build_global_ba_problem(state: ms.MapState, inv_sigma2, max_points: int = 32768,
                            obs_slots: int = 16):
    """The whole map as one BAProblem: every valid keyframe a camera, free
    but for slot 0 (gauge), every point slot below `max_points` with its
    observation rows. Returns the tuple `build_local_ba_problem` returns,
    so `writeback_local_ba` applies unchanged. Every tensor of the problem
    is a copy: the map is updated in place while a time-sliced global BA
    runs on the problem."""
    Kcap = state.capacity_kf
    dev = state.kf_valid.device
    cam_ids = torch.arange(Kcap, dtype=torch.int32, device=dev)
    pts = torch.arange(min(max_points, state.capacity_mp), dtype=torch.int32, device=dev)
    pt_ok = state.mp_valid[pts]
    obs_kf = state.mp_obs_kf[pts][:, :obs_slots]
    obs_ft = state.mp_obs_feat[pts][:, :obs_slots]
    okf = _i64(torch.clamp(obs_kf, 0, Kcap - 1))
    obs_ok = (obs_kf >= 0) & pt_ok[:, None] & state.kf_valid[okf]
    ftc = _i64(torch.clamp(obs_ft, 0, state.kf_xy.shape[1] - 1))
    octv = state.kf_octave[okf, ftc]
    prob = ba.BAProblem(
        cam_Tcw=state.kf_Tcw.clone(),
        cam_free=state.kf_valid & (cam_ids != 0),
        points=state.mp_pos[pts],
        point_valid=pt_ok,
        obs_cam=okf,
        obs_uv=state.kf_xy[okf, ftc],
        obs_ur=torch.where(obs_ok, state.kf_ur[okf, ftc], -1.0),
        obs_inv_sigma2=inv_sigma2[_i64(torch.clamp(octv, 0, inv_sigma2.shape[0] - 1))],
        obs_valid=obs_ok,
    )
    return prob, cam_ids, state.kf_valid.clone(), pts, pt_ok


# ---------------------------------------------------------------------------
# keyframe culling (ORB-SLAM2 LocalMapping::KeyFrameCulling)
# ---------------------------------------------------------------------------


def keyframe_redundancy(state: ms.MapState, kf_ids) -> torch.Tensor:
    """Fraction of each keyframe's bound points that >= 3 other keyframes
    observe at the same or a finer scale (+1 octave). `kf_ids` is an int
    or a 1-D tensor; returns a 0-d or [n] float tensor."""
    S = state.kf_point_idx.shape[1]
    dev = state.kf_point_idx.device
    single = not torch.is_tensor(kf_ids) or kf_ids.dim() == 0
    ks = kf_index(kf_ids, dev) if single else _i64(kf_ids)
    pid = state.kf_point_idx[ks]                          # [n, S]
    pidc = _i64(torch.clamp(pid, 0, state.capacity_mp - 1))
    bound = (pid >= 0) & state.mp_valid[pidc] & state.kf_feat_valid[ks]
    obs_kf = state.mp_obs_kf[pidc]                        # [n, S, O]
    live = (obs_kf >= 0) & (obs_kf != ks[:, None, None]) & bound[..., None]
    okf = _i64(torch.clamp(obs_kf, 0, state.capacity_kf - 1))
    oft = _i64(torch.clamp(state.mp_obs_feat[pidc], 0, S - 1))
    fine = live & (state.kf_octave[okf, oft] <= state.kf_octave[ks][..., None] + 1) & state.kf_valid[okf]
    redundant = bound & (torch.sum(fine, dim=-1) >= 3)
    red = torch.sum(redundant, dim=-1) / torch.clamp(torch.sum(bound, dim=-1), min=1)
    return red[0] if single else red


def kf_cull_pressure_scores(state: ms.MapState) -> torch.Tensor:
    """Redundancy of every keyframe slot, -1 where culling is not allowed:
    free slots, slot 0 (the gauge) and the 5 most recent inserts."""
    K = state.capacity_kf
    ids = torch.arange(K, device=state.kf_valid.device)
    red = keyframe_redundancy(state, ids)
    protect = ~state.kf_valid | (ids == 0) | (state.kf_seq >= state.num_kf - 5)
    return torch.where(protect, -1.0, red)


def remove_keyframe(state: ms.MapState, kf_id: int) -> None:
    """SetBadFlag for a keyframe (ORB-SLAM2 KeyFrame::SetBadFlag): erase
    its observations, detach it from the covisibility and loop graphs,
    reparent its spanning-tree children and re-anchor the points it was
    the reference of. A cold path: the reparenting runs on the host."""
    S = state.kf_point_idx.shape[1]
    P = state.capacity_mp
    Kcap = state.capacity_kf
    k = int(kf_id)
    pid = state.kf_point_idx[k].clone()
    erase_observations(state, torch.clamp(pid, 0, P - 1),
                       torch.full((S,), k, dtype=torch.int64, device=pid.device), pid >= 0)

    # greedy reparenting: each child attaches to its strongest covisible
    # among {the removed keyframe's parent} U {children reparented so far},
    # best pair first; a child with no covisible candidate falls back to
    # the grandparent
    parents = state.kf_parent.cpu().numpy().copy()
    covis = state.covis.cpu().numpy()
    parent = int(parents[k])
    idx = np.arange(Kcap)
    remaining = (parents == k) & state.kf_valid.cpu().numpy() & (idx != k)
    cand = np.zeros(Kcap, bool)
    if parent >= 0:
        cand[parent] = True
    while remaining.any():
        w = np.where(remaining[:, None] & cand[None, :], covis, -1)
        ci, cj = divmod(int(np.argmax(w)), Kcap)
        if w[ci, cj] > 0:
            child, new_p = ci, cj
        else:
            child, new_p = int(np.argmax(remaining)), parent
        parents[child] = new_p
        cand[child] = True
        remaining[child] = False
    state.kf_parent.copy_(torch.from_numpy(parents))

    state.covis[k, :] = 0
    state.covis[:, k] = 0
    # slots are recycled: a stale loop-edge row would attach this
    # keyframe's loop constraint to an unrelated new keyframe
    state.loop_edges[k, :] = False
    state.loop_edges[:, k] = False
    # points referenced to this keyframe move to their first surviving
    # observer; a stale reference would name whatever recycles the slot
    rows = state.mp_obs_kf
    has = rows >= 0
    first = torch.argmax(has.to(torch.int32), dim=1)
    new_ref = torch.where(torch.any(has, dim=1), torch.gather(rows, 1, first[:, None])[:, 0], -1)
    refd = (state.mp_ref_kf == k) & state.mp_valid
    state.mp_ref_kf.copy_(torch.where(refd, new_ref, state.mp_ref_kf))
    state.kf_valid[k] = False
    state.kf_point_idx[k] = -1


# ---------------------------------------------------------------------------
# host-side local mapper
# ---------------------------------------------------------------------------


class LocalMapper:
    """Host bookkeeping around the fused keyframe step (the probation
    window of recent points, keyframe culling), and the unfused mapping
    iteration."""

    RECENT_WINDOW = 4096  # fixed-size probation window

    def __init__(self, cfg: SlamConfig, K: cam_geo.Intrinsics, bounds, device):
        self.cfg = cfg
        self.K = K
        self.bounds = bounds
        nl = cfg.orb.num_levels
        sf = cfg.orb.scale_factor
        self.scale_factors = torch.tensor([sf**i for i in range(nl)], dtype=torch.float32,
                                          device=device)
        self.level_sigma2 = torch.tensor([sf ** (2 * i) for i in range(nl)], dtype=torch.float32,
                                         device=device)
        self.inv_sigma2 = 1.0 / self.level_sigma2
        self.recent_points = np.zeros((0,), np.int32)
        self._window_n = 0
        self.n_keyframes = 0
        # host mirror of the live keyframe count (slots recycle)
        self.live_kfs = 0
        # (culled_kf, parent_kf, Tcp) records; the System drains these to
        # re-anchor trajectory entries logged against culled keyframes
        self.culled_log: list[tuple[int, int, np.ndarray]] = []

    def probation_window(self) -> np.ndarray:
        """The fixed-size [W] window of recent point ids (-1 padded), as a
        host array: the fused step moves it to the card only when the frame
        becomes a keyframe."""
        W = self.RECENT_WINDOW
        window = np.full(W, -1, np.int32)
        n = min(len(self.recent_points), W)
        if n:
            window[:n] = self.recent_points[-n:]
        # what `after_keyframe` aligns `keep` with when no window_ids come
        self._window_n = n
        return window

    def after_keyframe(self, state: ms.MapState, kf_id: int, new_pids, keep,
                       cull_ids=None, cull_red=None, window_ids=None) -> None:
        """Host bookkeeping after a keyframe step: update the probation
        window and cull redundant keyframes, in place.

        With `window_ids`, the snapshot `keep` was computed against, the
        culled ids leave the window as a set difference; without, `keep`
        is aligned with the last `probation_window()`. With `cull_ids` /
        `cull_red`, the fused step's redundancy of the keyframe's covisible
        neighbours, a neighbour above 90 % is culled from the 12th keyframe
        on; without, every 4th keyframe from the 12th on checks the top 3
        covisible keyframes one at a time and culls the first above 90 %.
        When the slot pool runs dry the most redundant keyframe is recycled
        regardless of the bar."""
        self.n_keyframes += 1
        self.live_kfs += 1
        W = self.RECENT_WINDOW
        keep = _numpy(keep)
        if window_ids is not None:
            wids = np.asarray(window_ids)
            removed = wids[(wids >= 0) & ~keep[: len(wids)]]
            if len(removed):
                self.recent_points = self.recent_points[~np.isin(self.recent_points, removed)]
        elif self._window_n:
            n = self._window_n
            self.recent_points = self.recent_points[-n:][keep[:n]]
        fresh = _numpy(new_pids)
        fresh = fresh[fresh >= 0].astype(np.int32)
        if len(fresh):
            self.recent_points = np.concatenate([self.recent_points, fresh])[-W:]

        if cull_ids is not None:
            if self.n_keyframes >= 12:
                for c, r in zip(_numpy(cull_ids), _numpy(cull_red)):
                    if c >= 0 and c != kf_id and r > 0.9:
                        self._cull(state, int(c))
        elif self.n_keyframes % 4 == 0 and self.n_keyframes >= 12:
            covis = state.covis[kf_id].cpu().numpy()
            for c in np.argsort(-covis)[:3]:
                c = int(c)
                if c == 0 or c == kf_id or covis[c] < self.cfg.map.covis_threshold:
                    continue
                if float(keyframe_redundancy(state, c)) > 0.9:
                    self._cull(state, c)
                    break
        self._pressure_cull(state, kf_id)

    def post_keyframe(self, state: ms.MapState, kf_id: int, new_pids) -> None:
        """The unfused path's tail after a keyframe, in place: probation
        culling over the window, local BA from the third keyframe on, then
        `after_keyframe` on its window and culling branches."""
        from orbslam2_tpu_torch.pipeline import fused

        window = torch.as_tensor(self.probation_window(), device=state.kf_Tcw.device)
        keep = cull_points(state, window, state.kf_seq[kf_id].clone())
        if int(state.num_kf) >= 3:
            sc = self.cfg.solver
            fused.local_ba_step(
                state, kf_id, self.inv_sigma2, self.K,
                max_local=sc.ba_max_local_kfs, max_fixed=sc.ba_max_fixed_kfs,
                max_points=sc.ba_max_points, obs_slots=int(state.obs_slots),
                iters1=sc.local_ba_iters_first, iters2=sc.local_ba_iters_second,
            )
        self.after_keyframe(state, kf_id, new_pids, keep)

    def process_keyframe(self, state: ms.MapState, kf_id: int, run_ba: bool = True) -> None:
        """One LocalMapping iteration for an inserted keyframe, in place
        (ORB-SLAM2 LocalMapping::Run, unfused): refresh the statistics of
        its points, cull over the whole recent-point list, triangulate
        against the top covisible neighbours (10, or 20 for mono), refresh
        the new points, fuse both ways with the first 5 neighbours, then
        local BA. The neighbours are ordered by numpy's `argsort` of the
        host covisibility row, as the reference orders them, so ties
        break alike. Only valid entries of an id list are refreshed, so
        point 0 is refreshed where the reference's -1 fillers leave it
        stale (`map_state.recompute_point_stats`)."""
        cfg = self.cfg
        dev = state.kf_Tcw.device
        nl = cfg.orb.num_levels
        ms.recompute_point_stats(state, state.kf_point_idx[kf_id].clone(), self.scale_factors)

        if len(self.recent_points):
            keep = cull_points(state, torch.as_tensor(self.recent_points, device=dev),
                               state.kf_seq[kf_id].clone())
            self.recent_points = self.recent_points[keep.cpu().numpy()]

        n_neigh = 20 if cfg.sensor.name == "MONOCULAR" else 10
        covis = torch.where(state.kf_valid, state.covis[kf_id], 0).cpu().numpy()
        neighbors = [int(k) for k in np.argsort(-covis)[:n_neigh]
                     if covis[k] >= cfg.map.covis_threshold]
        new_pids = create_new_points(cfg, state, kf_id, self.K, self.scale_factors,
                                     self.level_sigma2, neighbors)
        if new_pids.shape[0]:
            self.recent_points = np.concatenate([self.recent_points, new_pids.cpu().numpy()])
            ms.recompute_point_stats(state, new_pids, self.scale_factors)

        mine = state.kf_point_idx[kf_id].clone()
        for nkf in neighbors[:5]:
            fuse_points_into_kf(state, mine, mine >= 0, nkf, self.K, self.scale_factors,
                                self.bounds, num_levels=nl)
            theirs = state.kf_point_idx[nkf].clone()
            fuse_points_into_kf(state, theirs, theirs >= 0, kf_id, self.K, self.scale_factors,
                                self.bounds, num_levels=nl)

        if run_ba and int(state.num_kf) >= 3:
            sc = cfg.solver
            prob, cam_ids, cam_present, pts, pt_ok = build_local_ba_problem(
                state, kf_id, self.inv_sigma2, max_local=sc.ba_max_local_kfs,
                max_fixed=sc.ba_max_fixed_kfs, max_points=sc.ba_max_points,
                obs_slots=int(state.obs_slots),
            )
            res = ba.two_phase_bundle_adjust(prob, self.K, iters1=sc.local_ba_iters_first,
                                             iters2=sc.local_ba_iters_second)
            writeback_local_ba(state, res, prob, cam_ids, cam_present, pts, pt_ok)

    def _pressure_cull(self, state: ms.MapState, kf_id: int) -> None:
        """Recycle the most redundant keyframes while fewer than 3 slots
        are free, so mapping never stops for lack of a slot."""
        cap = state.capacity_kf
        if self.live_kfs < cap - 4:
            return
        # near the edge: resync the host mirror from the card
        self.live_kfs = int(torch.sum(state.kf_valid))
        while self.live_kfs >= cap - 2:
            red = kf_cull_pressure_scores(state).cpu().numpy()
            red[kf_id] = -1.0
            c = int(np.argmax(red))
            if red[c] < 0:
                break  # nothing cullable
            self._cull(state, c)

    def _cull(self, state: ms.MapState, c: int) -> None:
        """Remove keyframe c and record (c, parent, Tcp) so the caller can
        re-anchor trajectory entries that reference it."""
        parent = int(state.kf_parent[c])
        Tc = state.kf_Tcw[c].cpu().numpy()
        Tp = state.kf_Tcw[min(max(parent, 0), state.capacity_kf - 1)].cpu().numpy()
        Tcp = Tc @ np.linalg.inv(Tp) if parent >= 0 else np.eye(4)
        self.culled_log.append((c, max(parent, -1), Tcp))
        self.live_kfs -= 1
        remove_keyframe(state, c)
