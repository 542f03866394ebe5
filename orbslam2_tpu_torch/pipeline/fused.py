"""The per-frame tracking step and the RGB-D frame program.

Port of `orbslam2_tpu.pipeline.fused` for RGB-D tracking without mapping:
`track_step` (reference-keyframe coarse tracking with a motion-model
fallback, then two local-map association / pose-optimisation passes),
`track_frame_rgbd` (frame build + track step) and
`frame_and_keyframe_step` for ``sensor="rgbd"`` with the keyframe
decision computed but no keyframe branch: keyframe insertion and mapping
are not ported yet.

PyTorch runs eagerly, so "fused" names the stage boundaries of the
reference rather than one compiled program. The map is updated in place.

The reference's ``lax.cond`` on ``use_ref`` becomes a Python ``if`` on the
value read back from the card: one host synchronisation per frame, and the
motion-model branch (two K1 and one K2 launches) runs only on the frames
that need it, as the untaken ``lax.cond`` branch did. Each frame therefore
launches K1 at least 3 times (reference-keyframe match, two local passes)
and K2 at least 3 times, 5 and 4 with the motion model.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import camera as cam_geo
from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.ops.orb import OrbExtractor
from orbslam2_tpu_torch.pipeline import tracking as trk
from orbslam2_tpu_torch.pipeline.frame import FrameData, rgbd_frame
from orbslam2_tpu_torch.slam_map import map_state as ms
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


class FrameStepOut(NamedTuple):
    """Results of one steady-state frame. The `next_*` fields are the
    tracker anchors for the following frame. The reference's keyframe
    outputs (kf_id, kf_Tcw, new_pids, culling candidates) come with the
    keyframe branch, which is not ported."""

    track: TrackOut
    is_kf: torch.Tensor                # bool: the keyframe decision
    accept: torch.Tensor               # bool: ok AND >= min_inliers_local
    next_Tcw: torch.Tensor             # [4, 4]
    next_point_idx: torch.Tensor       # [S]
    next_velocity: torch.Tensor        # [4, 4]
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
    K: cam_geo.Intrinsics,
    p: TrackParams,
    inv_depth_factor: float,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
    has_distortion: bool = False,
    max_gap: int = 15,
    min_gap: int = 0,
    kf_ratio: float = 0.75,
    use_close_cond: bool = True,
    sensor: str = "rgbd",
) -> tuple[FrameData, FrameStepOut]:
    """One steady-state frame: frame build, tracking and the keyframe
    policy (ORB-SLAM2 NeedNewKeyFrame). With mapping disabled the decision
    is always false, as in the reference."""
    if sensor != "rgbd":
        raise NotImplementedError(f"sensor={sensor!r}: only RGB-D is ported")
    if mapping_enabled:
        raise NotImplementedError("keyframe insertion and mapping are not ported")
    frame, out = track_frame_rgbd(
        state, extractor, image, depth_map, frame_id,
        last_xy, last_point_idx, last_octave, last_angle, last_desc,
        last_Tcw, velocity, has_velocity, ref_kf, K, p, inv_depth_factor,
        max_local_kfs=max_local_kfs, max_local_points=max_local_points,
        num_levels=num_levels, has_distortion=has_distortion,
    )

    ratio = 0.4 if n_keyframes <= 2 else kf_ratio
    need_ratio = out.n_inliers < ratio * torch.clamp(out.ref_tracked, min=1)
    close_cond = (out.close_tracked < 100) & (out.close_free > 70) if use_close_cond else False
    c1 = frames_since_kf >= max_gap
    c2 = (need_ratio | close_cond) & (frames_since_kf >= min_gap)
    need_kf = (
        out.ok & (c2 | c1) & (out.n_inliers > 15)
        & (out.n_inliers >= p.min_track_local)
        & torch.any(~state.kf_valid) & mapping_enabled
    )
    # without a keyframe branch the anchors are the tracked ones
    res = FrameStepOut(
        track=out,
        is_kf=need_kf,
        accept=out.ok & (out.n_inliers >= p.min_track_local),
        next_Tcw=out.Tcw,
        next_point_idx=out.point_idx,
        next_velocity=out.Tcw @ se3.inverse(last_Tcw),
        next_frames_since_kf=frames_since_kf + 1,
    )
    return frame, res
