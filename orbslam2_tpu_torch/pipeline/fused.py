"""The per-frame and per-keyframe steps of the pipeline.

Port of `orbslam2_tpu.pipeline.fused`:
- `track_step` (reference-keyframe coarse tracking with a motion-model
  fallback, then two local-map association / pose-optimisation passes),
  and `track_frame_rgbd` and `track_frame_stereo` (frame build + track
  step);
- `keyframe_step` (insertion, depth-seeded points, triangulation, fusion),
  `local_ba_step`, `_reanchor_depth_seeds`, `deferred_local_ba` (the last
  two after the first, for a keyframe whose step skipped BA) and
  `keyframe_full_step` (all of them plus probation culling and the
  keyframe-redundancy sweep);
- `frame_and_keyframe_step`, which builds the frame for any sensor
  (RGB-D, stereo or monocular), tracks it and runs the keyframe branch on
  the frames the policy picks.

PyTorch runs eagerly, so "fused" names the stage boundaries of the
reference rather than one compiled program. The map is updated in place.

The reference's ``lax.cond``s become Python ``if``s on values read back
from the card. On ``use_ref`` that is one host synchronisation per frame,
and the motion-model branch (two K1 and one K2 launches) runs only on the
frames that need it, as the untaken ``lax.cond`` branch did. Each frame
therefore launches K1 at least 3 times (reference-keyframe match, two
local passes) and K2 at least 3 times, 5 and 4 with the motion model; a
stereo frame adds one K1 launch for its left-right match. A
keyframe adds K1 launches for triangulation (one per neighbour) and
fusion (one per target, and one for the union back into the keyframe);
K2 does not run in mapping.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_tpu_torch.geometry import camera as cam_geo
from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.ops.orb import OrbExtractor
from orbslam2_tpu_torch.pipeline import local_mapping as lm
from orbslam2_tpu_torch.pipeline import tracking as trk
from orbslam2_tpu_torch.pipeline.frame import FrameData, monocular_frame, rgbd_frame, stereo_frame
from orbslam2_tpu_torch.slam_map import map_state as ms
from orbslam2_tpu_torch.solvers import ba
from orbslam2_tpu_torch.solvers.cuda_pose_opt import pose_optimize_fast


class TrackParams(NamedTuple):
    """Per-session tracking parameters."""

    scale_factors: torch.Tensor  # [L] on the session device
    inv_sigma2: torch.Tensor     # [L]
    bounds: tuple                # (xmin, xmax, ymin, ymax)
    radius_th: float             # motion-model base radius (7 or 15)
    min_track: int               # min inliers to accept a stage
    close_depth: float           # ThDepth * baseline
    min_track_local: int         # TrackLocalMap accept gate (30 inliers)
    match_max_dist: int          # Hamming gate for projection searches


class TrackOut(NamedTuple):
    Tcw: torch.Tensor
    point_idx: torch.Tensor
    ok: torch.Tensor             # bool: tracking healthy
    n_inliers: torch.Tensor
    ref_tracked: torch.Tensor
    close_tracked: torch.Tensor
    close_free: torch.Tensor


def track_step(
    state: ms.MapState,
    frame: FrameData,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    last_Tcw,
    velocity,
    has_velocity: bool,
    ref_kf: int,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
) -> TrackOut:
    """One tracking step (ORB-SLAM2 Track() minus keyframe creation).
    Updates the map's visibility counters in place."""
    # ---- coarse stage B: reference keyframe (always computed). Preferred
    # whenever healthy: motion-model associations are radius-censored
    # around the velocity prediction and can be wrong but self-consistent
    bind_ref = trk.reference_kf_match(
        state.kf_desc[ref_kf], state.kf_point_idx[ref_kf],
        state.kf_angle[ref_kf], state.kf_feat_valid[ref_kf],
        state.mp_valid, frame,
    )
    obs_ref = trk.build_pose_observations(bind_ref, frame, state.mp_pos, state.mp_valid, p.inv_sigma2)
    # the coarse stages only seed the local-map passes: a short schedule
    res_ref = pose_optimize_fast(last_Tcw, obs_ref, K, rounds=2, iters=6)
    ok_ref = res_ref.num_inliers >= p.min_track
    use_ref = ok_ref & (res_ref.num_inliers >= 15)

    if bool(use_ref):
        Tcw = res_ref.Tcw
        bind = torch.where(res_ref.inliers, bind_ref, -1)
        coarse_ok = ok_ref
    else:
        # ---- coarse stage A: motion model, only when the anchor is weak
        Tcw_pred = velocity @ last_Tcw
        bind_r1, _ = trk.motion_model_match(
            Tcw_pred, last_xy, last_point_idx, last_octave, last_angle,
            last_desc, state.mp_pos, state.mp_valid, frame, K,
            p.scale_factors, p.radius_th, p.match_max_dist,
        )
        bind_r2, _ = trk.motion_model_match(
            Tcw_pred, last_xy, last_point_idx, last_octave, last_angle,
            last_desc, state.mp_pos, state.mp_valid, frame, K,
            p.scale_factors, 2.0 * p.radius_th, p.match_max_dist,
        )
        bind_mm = torch.where(torch.sum(bind_r1 >= 0) >= 20, bind_r1, bind_r2)
        obs_mm = trk.build_pose_observations(bind_mm, frame, state.mp_pos, state.mp_valid, p.inv_sigma2)
        res_mm = pose_optimize_fast(Tcw_pred, obs_mm, K, rounds=2, iters=6)
        ok_mm = (
            (res_mm.num_inliers >= p.min_track) & (torch.sum(bind_mm >= 0) >= 20) & has_velocity
        )
        Tcw = torch.where(ok_mm, res_mm.Tcw, res_ref.Tcw)
        bind = torch.where(
            ok_mm, torch.where(res_mm.inliers, bind_mm, -1), torch.where(res_ref.inliers, bind_ref, -1)
        )
        coarse_ok = ok_mm | ok_ref

    # ---- local map: gather + two association / optimisation passes ----
    _, _, lpts, lpts_mask, _ = trk.gather_local_map(
        state, bind, max_local_kfs=max_local_kfs, max_local_points=max_local_points
    )

    def local_pass(Tcw, bind_seed, radius_mult, rounds, iters):
        b, vis = trk.search_local_points(
            state, lpts, lpts_mask, Tcw, bind_seed, frame, K,
            p.scale_factors, p.bounds, radius_mult, num_levels=num_levels,
            max_dist=p.match_max_dist,
        )
        obs = trk.build_pose_observations(b, frame, state.mp_pos, state.mp_valid, p.inv_sigma2)
        r = pose_optimize_fast(Tcw, obs, K, rounds=rounds, iters=iters)
        return r.Tcw, torch.where(r.inliers, b, -1), r.num_inliers, vis

    # pass 1 refines the coarse seed (3x6); pass 2, seeded with pass 1's
    # inlier bindings, only adds matches for still-unbound features
    T1, b1, n1, vis1 = local_pass(Tcw, bind, 1.0, rounds=3, iters=6)
    acc1 = n1 >= p.min_track
    T1s = torch.where(acc1, T1, Tcw)
    b1s = torch.where(acc1, b1, bind)
    T2, b2, n2, vis2 = local_pass(T1s, b1s, 0.6, rounds=4, iters=6)
    acc2 = (n2 >= n1) & (n2 >= p.min_track)
    Tcw_f = torch.where(acc2, T2, T1s)
    bind_f = torch.where(acc2, b2, b1s)
    n_inl = torch.where(acc2, n2, torch.where(acc1, n1, 0))

    P = state.capacity_mp
    trk.update_seen_counters(state, lpts, vis1 | vis2, torch.clamp(bind_f, 0, P - 1), bind_f >= 0)

    # ---- keyframe-policy scalars: only points observed by >= 3
    # keyframes (2 while the map has <= 2) count toward ref coverage
    rpid = state.kf_point_idx[ref_kf]
    rpid_c = torch.clamp(rpid, 0, P - 1).to(torch.int64)
    min_obs = torch.where(state.num_kf > 2, 3, 2)
    ref_tracked = torch.sum(
        (rpid >= 0) & state.kf_feat_valid[ref_kf]
        & state.mp_valid[rpid_c] & (state.mp_n_obs[rpid_c] >= min_obs)
    )
    close = (frame.depth > 0) & (frame.depth < p.close_depth) & frame.valid
    # health rides the final evidence: a local count of 3x the accept gate
    # cannot come from a diverged pose (the reference's acceptance,
    # copied as it is)
    strong_local = n_inl >= 3 * p.min_track_local
    return TrackOut(
        Tcw=Tcw_f,
        point_idx=bind_f,
        ok=(coarse_ok | strong_local) & (n_inl >= p.min_track),
        n_inliers=n_inl,
        ref_tracked=ref_tracked,
        close_tracked=torch.sum(close & (bind_f >= 0)),
        close_free=torch.sum(close & (bind_f < 0)),
    )


def track_frame_rgbd(
    state: ms.MapState,
    extractor: OrbExtractor,
    image,
    depth_map,
    frame_id: int,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    last_Tcw,
    velocity,
    has_velocity: bool,
    ref_kf: int,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    inv_depth_factor: float,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
    has_distortion: bool = False,
) -> tuple[FrameData, TrackOut]:
    """Frame construction (ORB extraction + depth seeding + undistortion)
    and the tracking step. Returns (FrameData, TrackOut)."""
    frame = rgbd_frame(extractor, image, depth_map, frame_id, 0.0, K,
                       inv_depth_factor, has_distortion)
    out = track_step(
        state, frame, last_xy, last_point_idx, last_octave, last_angle,
        last_desc, last_Tcw, velocity, has_velocity, ref_kf, K, p,
        max_local_kfs=max_local_kfs, max_local_points=max_local_points,
        num_levels=num_levels,
    )
    return frame, out


def track_frame_stereo(
    state: ms.MapState,
    extractor: OrbExtractor,
    left,
    right,
    frame_id: int,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    last_Tcw,
    velocity,
    has_velocity: bool,
    ref_kf: int,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
    has_distortion: bool = False,
) -> tuple[FrameData, TrackOut]:
    """Stereo sibling of `track_frame_rgbd`: extraction of both images, the
    stereo match and the tracking step. Returns (FrameData, TrackOut)."""
    frame = stereo_frame(extractor, left, right, frame_id, 0.0, K, p.scale_factors,
                         has_distortion)
    out = track_step(
        state, frame, last_xy, last_point_idx, last_octave, last_angle,
        last_desc, last_Tcw, velocity, has_velocity, ref_kf, K, p,
        max_local_kfs=max_local_kfs, max_local_points=max_local_points,
        num_levels=num_levels,
    )
    return frame, out


# ---------------------------------------------------------------------------
# keyframe processing
# ---------------------------------------------------------------------------


def keyframe_step(
    state: ms.MapState,
    frame: FrameData,
    Tcw,
    point_idx,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    level_sigma2,
    scale_factor_last: float = 1.2**7,
    baseline: float = 0.1,
    covis_threshold: int = 15,
    n_neighbors: int = 5,
    n2_neighbors: int = 5,
    num_levels: int = 8,
    create_close_points: bool = True,
    all_depths: bool = False,
    recycle_min_age: int = 24,
) -> tuple[int, torch.Tensor]:
    """Insert a keyframe and run the mapping stages before BA (ORB-SLAM2
    LocalMapping::Run): slot recycling, insertion, depth-seeded points,
    triangulation against the top covisible neighbours, fusion both ways
    and the point-stat refresh.

    Returns (kf_id, new_point_ids [S], slot-aligned, -1 = none). Every
    match of a stage runs against the state as the stage found it, and its
    results are applied afterwards, one neighbour or target at a time."""
    S = frame.xy.shape[0]
    P = state.capacity_mp
    dev = frame.xy.device
    cols = torch.arange(S, dtype=torch.int32, device=dev)

    # 0) keep 2S slots free for this keyframe's points; the tracker's
    # current bindings are about to be recorded and must survive
    protect = torch.zeros(P, dtype=torch.bool, device=dev)
    ms.masked_put_(protect, point_idx, True, point_idx >= 0)
    lm.ensure_free_slots(state, state.num_kf.clone(), headroom=2 * S, protect=protect,
                         min_age=recycle_min_age)

    # 1) insert the keyframe with the tracker's bindings
    kf_id = ms.add_keyframe(
        state, frame.frame_id, Tcw, frame.xy, frame.ur, frame.depth, frame.octave,
        frame.angle, frame.desc, frame.valid, point_idx,
    )

    # 2) depth-seeded points: the close ones plus the 100 nearest
    if create_close_points:
        has_depth = frame.valid & (frame.depth > 0) & (point_idx < 0)
        if all_depths:
            create = has_depth
        else:
            depth_rank = torch.sum(
                (frame.depth[None, :] < frame.depth[:, None]) & has_depth[None, :], dim=1
            )
            create = has_depth & ((frame.depth < p.close_depth) | (depth_rank < 100))
        pw = se3.apply(se3.inverse(Tcw), cam_geo.backproject(frame.xy, frame.depth, K))
        rays = pw - se3.camera_center(Tcw)
        dist = torch.linalg.norm(rays, dim=-1)
        normal = rays / torch.clamp(dist[:, None], min=1e-9)
        max_d = dist * p.scale_factors[torch.clamp(frame.octave, 0, num_levels - 1).to(torch.int64)]
        ms.add_points(state, pw, create, kf_id, cols, frame.desc, normal,
                      max_d / scale_factor_last, max_d, frame.ur)

    # 3) triangulate against the top covisible neighbours, all against this
    # state; the first valid neighbour in covisibility order takes a slot
    w = state.covis[kf_id] * state.kf_valid
    _, neigh = trk._top_k(w, n_neighbors)
    neigh_ok = w[neigh] >= covis_threshold
    tri = [lm.triangulate_pair(state, kf_id, neigh[i], K, p.scale_factors, level_sigma2,
                               baseline, num_levels=num_levels)
           for i in range(n_neighbors)]
    f2_all, pw_all, ok_all, dist1_all = (torch.stack(x) for x in zip(*tri))
    ok_all = ok_all & neigh_ok[:, None] & (state.kf_point_idx[kf_id] < 0)[None, :]
    nsel = torch.argmax(ok_all.to(torch.int32), dim=0)     # [S] winning neighbour row
    any_ok = torch.any(ok_all, dim=0)
    pw = pw_all[nsel, cols]
    max_d = dist1_all[nsel, cols] * p.scale_factors[
        torch.clamp(state.kf_octave[kf_id], 0, num_levels - 1).to(torch.int64)
    ]
    rays = pw - se3.camera_center(state.kf_Tcw[kf_id])
    normal = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=1e-9)
    new_pids = ms.add_points(
        state, pw, any_ok, kf_id, cols, state.kf_desc[kf_id], normal,
        max_d / scale_factor_last, max_d, state.kf_ur[kf_id],
    )
    for i in range(n_neighbors):
        lm.bind_points_to_kf(state, neigh[i], f2_all[i], new_pids, (nsel == i) & (new_pids >= 0))

    # 4) fuse with the neighbours and their top neighbours (ORB-SLAM2
    # SearchInNeighbors): this keyframe's points into every target, all
    # matched against one state and applied in order; then the deduped
    # union of the targets' points into this keyframe
    mine = state.kf_point_idx[kf_id].clone()
    Kcap = state.capacity_kf
    w2 = torch.where(neigh_ok[:, None], state.covis[neigh] * state.kf_valid, 0)   # [n1, K]
    w2[:, kf_id] = 0                                       # not back to itself
    _, neigh2 = trk._top_k(w2, n2_neighbors)              # [n1, n2]
    ok2 = torch.gather(w2, 1, neigh2) > 0
    targets = torch.cat([neigh, neigh2.reshape(-1)])
    targets_ok = torch.cat([neigh_ok, ok2.reshape(-1)])
    Tn = targets.shape[0]
    order = torch.arange(Tn, device=dev)
    tpos = torch.full((Kcap + 1,), Tn, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(targets_ok, targets, Kcap), order, "amin", include_self=True
    )
    targets_ok = targets_ok & (tpos[targets] == order)

    feats = [lm.fuse_match(state, mine, mine >= 0, targets[t], K, p.scale_factors, p.bounds,
                           num_levels=num_levels)
             for t in range(Tn)]
    for t in range(Tn):
        lm.fuse_apply(state, torch.where(targets_ok[t], mine, -1), feats[t], targets[t])

    # the union, first occurrence only, compacted to its valid rows in
    # order (the one host read of this stage): the rows of a match are
    # independent and conflicts go to the lowest row, so the bindings are
    # those of the padded [Tn * S] union
    theirs = torch.where(targets_ok[:, None], state.kf_point_idx[targets], -1).reshape(-1)
    tclip = torch.clamp(theirs, 0, P - 1).to(torch.int64)
    M = theirs.shape[0]
    rows = torch.arange(M, device=dev)
    occ = torch.full((P + 1,), M, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(theirs >= 0, tclip, P), rows, "amin", include_self=True
    )
    theirs = theirs[(theirs >= 0) & (occ[tclip] == rows)]
    lm.fuse_points_into_kf(state, theirs, theirs >= 0, kf_id, K, p.scale_factors, p.bounds,
                           num_levels=num_levels)

    # 5) refresh the stats of this keyframe's points and the new ones
    ms.recompute_point_stats(state, state.kf_point_idx[kf_id].clone(), p.scale_factors)
    ms.recompute_point_stats(state, new_pids, p.scale_factors)
    return kf_id, new_pids


def local_ba_step(
    state: ms.MapState,
    kf_id,
    inv_sigma2,
    K: cam_geo.Intrinsics,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
    iters1: int = 5,
    iters2: int = 10,
) -> None:
    """Local BA around kf_id, in place: assembly, robust iterations,
    outlier removal, plain iterations, write-back."""
    prob, cam_ids, cam_present, pts, pt_ok = lm.build_local_ba_problem(
        state, kf_id, inv_sigma2, max_local=max_local, max_fixed=max_fixed,
        max_points=max_points, obs_slots=obs_slots,
    )
    res1 = ba.bundle_adjust(prob, K, iters=iters1, use_kernel=True)
    prob2 = prob._replace(
        cam_Tcw=res1.cam_Tcw, points=res1.points, obs_valid=prob.obs_valid & res1.obs_inlier
    )
    res2 = ba.bundle_adjust(prob2, K, iters=iters2, use_kernel=False)
    lm.writeback_local_ba(state, res2, prob, cam_ids, cam_present, pts, pt_ok)


def _reanchor_depth_seeds(state: ms.MapState, kf_id: int, K: cam_geo.Intrinsics) -> None:
    """Re-anchor kf_id's single-observer depth-seeded points to its
    post-BA pose. They were backprojected at the tracked pose; BA moves
    the keyframe but cannot constrain a one-observation point."""
    pid = state.kf_point_idx[kf_id].clone()
    pidc = torch.clamp(pid, 0, state.capacity_mp - 1).to(torch.int64)
    depth = state.kf_depth[kf_id]
    single = (
        (pid >= 0)
        & (torch.sum(state.mp_obs_kf[pidc] >= 0, dim=1) == 1)
        & (state.mp_first_kf[pidc] == state.kf_seq[kf_id])
        & (depth > 0)
    )
    pc = cam_geo.backproject(state.kf_xy[kf_id], depth, K)
    ms.masked_put_(state.mp_pos, pidc, se3.apply(se3.inverse(state.kf_Tcw[kf_id]), pc), single)


def deferred_local_ba(
    state: ms.MapState,
    kf_id: int,
    inv_sigma2,
    K: cam_geo.Intrinsics,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
    iters1: int = 5,
    iters2: int = 10,
) -> None:
    """Local BA around kf_id and the re-anchoring of its depth seeds, in
    place: what a keyframe step run with `defer_ba` left out, issued when
    the host resolves that keyframe (ORB-SLAM2's LocalMapping thread runs
    its BA after tracking has moved on)."""
    local_ba_step(
        state, kf_id, inv_sigma2, K, max_local=max_local, max_fixed=max_fixed,
        max_points=max_points, obs_slots=obs_slots, iters1=iters1, iters2=iters2,
    )
    _reanchor_depth_seeds(state, kf_id, K)


def keyframe_full_step(
    state: ms.MapState,
    frame: FrameData,
    Tcw,
    point_idx,
    probation_window,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    level_sigma2,
    inv_sigma2,
    scale_factor_last: float = 1.2**7,
    baseline: float = 0.1,
    covis_threshold: int = 15,
    n_neighbors: int = 5,
    n2_neighbors: int = 5,
    num_levels: int = 8,
    create_close_points: bool = True,
    all_depths: bool = False,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
    iters1: int = 5,
    iters2: int = 10,
    run_ba: bool = True,
    recycle_min_age: int = 24,
):
    """Keyframe insertion, mapping, probation culling over
    `probation_window` ([W] point ids, -1 padded; host or device), local BA
    and the redundancy of the covisible keyframes.

    Returns (kf_id, new_point_ids [S], window_keep [W], kf_Tcw, kf_point_idx
    [S], cull_ids [K] (-1 = not a candidate), cull_red [K]); the pose and
    bindings are the post-BA ones, copies."""
    kf_id, new_pids = keyframe_step(
        state, frame, Tcw, point_idx, K, p, level_sigma2,
        scale_factor_last=scale_factor_last, baseline=baseline,
        covis_threshold=covis_threshold, n_neighbors=n_neighbors,
        n2_neighbors=n2_neighbors, num_levels=num_levels,
        create_close_points=create_close_points, all_depths=all_depths,
        recycle_min_age=recycle_min_age,
    )
    dev = frame.xy.device
    window = torch.as_tensor(probation_window, dtype=torch.int32).to(dev)
    # "now" for probation ages is this keyframe's seq (slot ids recycle)
    keep = lm.cull_points(state, window, state.kf_seq[kf_id].clone())
    if run_ba:
        local_ba_step(
            state, kf_id, inv_sigma2, K, max_local=max_local, max_fixed=max_fixed,
            max_points=max_points, obs_slots=obs_slots, iters1=iters1, iters2=iters2,
        )
        _reanchor_depth_seeds(state, kf_id, K)
    # keyframe culling sweep over every covisible neighbour; the host reads
    # it with the other keyframe outputs
    Kc = state.capacity_kf
    wc = state.covis[kf_id] * state.kf_valid
    wc[0] = 0                                   # never cull the origin
    ids = torch.arange(Kc, dtype=torch.int32, device=dev)
    cull_ok = (wc >= covis_threshold) & (ids != kf_id)
    cull_red = torch.where(cull_ok, lm.keyframe_redundancy(state, ids), 0.0)
    cull_ids = torch.where(cull_ok, ids, -1)
    return (kf_id, new_pids, keep, state.kf_Tcw[kf_id].clone(),
            state.kf_point_idx[kf_id].clone(), cull_ids, cull_red)


class FrameStepOut(NamedTuple):
    """Results of one steady-state frame. The `next_*` fields are the
    tracker anchors for the following frame. `pose`, `ok`, `is_kf`,
    `accept`, `n_inliers` and `kf_id` are host values, read at once in the
    frame step; the keyframe outputs hold their no-keyframe defaults on
    other frames."""

    track: TrackOut
    pose: np.ndarray                   # [4, 4] float32: track.Tcw on the host
    ok: bool                           # track.ok on the host
    is_kf: bool                        # the keyframe decision
    kf_id: int                         # -1 when no keyframe
    kf_Tcw: torch.Tensor               # [4, 4] post-BA keyframe pose (or the track pose)
    kf_point_idx: torch.Tensor         # [S] post-BA bindings (or the track bindings)
    new_pids: torch.Tensor             # [S] (-1 when no keyframe)
    window_keep: torch.Tensor          # [W] bool
    cull_ids: torch.Tensor             # [K] covisible culling candidates (-1 = n/a)
    cull_red: torch.Tensor             # [K] their redundancy fractions
    accept: bool                       # ok AND >= min_inliers_local
    n_inliers: int
    next_Tcw: torch.Tensor             # [4, 4]
    next_point_idx: torch.Tensor       # [S]
    next_velocity: torch.Tensor        # [4, 4]
    next_ref_kf: int
    next_frames_since_kf: int


def frame_and_keyframe_step(
    state: ms.MapState,
    extractor: OrbExtractor,
    image,
    depth_map,
    frame_id: int,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    last_Tcw,
    velocity,
    has_velocity: bool,
    ref_kf: int,
    frames_since_kf: int,
    n_keyframes: int,
    mapping_enabled: bool,
    probation_window,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    inv_depth_factor: float,
    level_sigma2,
    inv_sigma2,
    scale_factor_last: float = 1.2**7,
    baseline: float = 0.1,
    covis_threshold: int = 15,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
    has_distortion: bool = False,
    n_neighbors: int = 5,
    n2_neighbors: int = 5,
    create_close_points: bool = True,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
    iters1: int = 5,
    iters2: int = 10,
    max_gap: int = 15,
    min_gap: int = 0,
    kf_ratio: float = 0.75,
    use_close_cond: bool = True,
    sensor: str = "rgbd",
    defer_ba: bool = False,
    recycle_min_age: int = 24,
) -> tuple[FrameData, FrameStepOut]:
    """One steady-state frame: frame build, tracking, the keyframe policy
    (ORB-SLAM2 NeedNewKeyFrame) and, on a keyframe, `keyframe_full_step`.

    `sensor` selects the frame build: "rgbd" (image and depth map),
    "stereo" (image = left, depth_map = right) or "mono" (depth_map is
    ignored); tracking and the keyframe logic are shared.

    The reference's ``lax.cond`` on the decision becomes a Python ``if``
    on one host read of (accept, inliers, decision, coarse health, pose),
    what the host needs for every frame anyway: the keyframe branch runs
    only on keyframes. `probation_window` may be a host array; it reaches
    the card only on a keyframe. With mapping disabled the decision is
    false. With `defer_ba` the keyframe branch skips local BA, which the
    caller then runs through `deferred_local_ba`."""
    last = (last_xy, last_point_idx, last_octave, last_angle, last_desc, last_Tcw, velocity,
            has_velocity, ref_kf, K, p)
    sizes = dict(max_local_kfs=max_local_kfs, max_local_points=max_local_points,
                 num_levels=num_levels)
    if sensor == "rgbd":
        frame, out = track_frame_rgbd(
            state, extractor, image, depth_map, frame_id, *last, inv_depth_factor,
            has_distortion=has_distortion, **sizes,
        )
    elif sensor == "stereo":
        frame, out = track_frame_stereo(
            state, extractor, image, depth_map, frame_id, *last,
            has_distortion=has_distortion, **sizes,
        )
    elif sensor == "mono":
        frame = monocular_frame(extractor, image, frame_id, 0.0, K, has_distortion)
        out = track_step(state, frame, *last, **sizes)
    else:
        raise ValueError(f"unknown sensor {sensor!r}")

    ratio = 0.4 if n_keyframes <= 2 else kf_ratio
    need_ratio = out.n_inliers < ratio * torch.clamp(out.ref_tracked, min=1)
    close_cond = (out.close_tracked < 100) & (out.close_free > 70) if use_close_cond else False
    c1 = frames_since_kf >= max_gap
    c2 = (need_ratio | close_cond) & (frames_since_kf >= min_gap)
    accept = out.ok & (out.n_inliers >= p.min_track_local)
    # the policy must not out-accept the host's LOST gate, or it would
    # insert a keyframe on a frame the host then drops
    need_kf = (
        accept & (c2 | c1) & (out.n_inliers > 15)
        & torch.any(~state.kf_valid) & mapping_enabled
    )
    # float64 holds the counts and the float32 pose exactly
    flags = torch.stack([accept, out.n_inliers, need_kf, out.ok]).to(torch.float64)
    host = torch.cat([flags, out.Tcw.reshape(-1).to(torch.float64)]).tolist()
    accept, n_inl, is_kf, ok = bool(host[0]), int(host[1]), bool(host[2]), bool(host[3])
    pose = np.asarray(host[4:], np.float32).reshape(4, 4)

    S = frame.xy.shape[0]
    if is_kf:
        kf_id, new_pids, keep, kf_Tcw, kf_bind, cull_ids, cull_red = keyframe_full_step(
            state, frame, out.Tcw, out.point_idx, probation_window, K, p,
            level_sigma2, inv_sigma2,
            scale_factor_last=scale_factor_last, baseline=baseline,
            covis_threshold=covis_threshold, n_neighbors=n_neighbors,
            n2_neighbors=n2_neighbors, num_levels=num_levels,
            create_close_points=create_close_points,
            max_local=max_local, max_fixed=max_fixed, max_points=max_points,
            obs_slots=obs_slots, iters1=iters1, iters2=iters2,
            run_ba=not defer_ba, recycle_min_age=recycle_min_age,
        )
    else:
        dev = frame.xy.device
        Kc = state.capacity_kf
        kf_id, kf_Tcw, kf_bind = -1, out.Tcw, out.point_idx
        new_pids = torch.full((S,), -1, dtype=torch.int32, device=dev)
        keep = torch.zeros(len(probation_window), dtype=torch.bool, device=dev)
        cull_ids = torch.full((Kc,), -1, dtype=torch.int32, device=dev)
        cull_red = torch.zeros(Kc, device=dev)
    res = FrameStepOut(
        track=out,
        pose=pose,
        ok=ok,
        is_kf=is_kf,
        kf_id=kf_id,
        kf_Tcw=kf_Tcw,
        kf_point_idx=kf_bind,
        new_pids=new_pids,
        window_keep=keep,
        cull_ids=cull_ids,
        cull_red=cull_red,
        accept=accept,
        n_inliers=n_inl,
        next_Tcw=kf_Tcw,
        next_point_idx=kf_bind,
        next_velocity=out.Tcw @ se3.inverse(last_Tcw),
        next_ref_kf=kf_id if is_kf else ref_kf,
        next_frames_since_kf=0 if is_kf else frames_since_kf + 1,
    )
    return frame, res
