"""Tracking: the per-frame front-end state machine.

Port of `orbslam2_tpu.pipeline.tracking`: the matching and local-map
stages as functions on tensors, and the host-side `Tracker`
(NOT_INITIALIZED -> OK <-> LOST) that sequences them, with the stereo /
RGB-D and the monocular (two-view H/F) initializations, relocalization
from the loop closer's keyframe database and its warm-up, and the
localization-mode visual odometry (mbVO).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam2_tpu_torch.config import SlamConfig, Sensor
from orbslam2_tpu_torch.geometry import camera as cam_geo
from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.ops import match
from orbslam2_tpu_torch.pipeline.frame import FrameBuilder, FrameData
from orbslam2_tpu_torch.slam_map import map_state as ms
from orbslam2_tpu_torch.solvers import epnp
from orbslam2_tpu_torch.solvers import initializer as mono_init
from orbslam2_tpu_torch.solvers import pose_opt
from orbslam2_tpu_torch.solvers.cuda_pose_opt import pose_optimize_fast
from orbslam2_tpu_torch.vocab import bow


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class TrackResult(NamedTuple):
    Tcw: np.ndarray
    state: TrackState
    num_inliers: int
    is_keyframe: bool


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def motion_model_match(
    Tcw_pred, last_xy, last_point_idx, last_octave, last_angle, last_desc,
    mp_pos, mp_valid, frame: FrameData, K: cam_geo.Intrinsics, scale_factors,
    radius_th, max_dist=match.TH_HIGH,
):
    """Project the last frame's bound points into the predicted pose and
    match them (frame-to-frame SearchByProjection).

    Returns (point_idx [S] int32 bindings for the current frame, pred_uv)."""
    S = last_xy.shape[0]
    pid = _i64(torch.clamp(last_point_idx, 0, mp_pos.shape[0] - 1))
    has_point = (last_point_idx >= 0) & mp_valid[pid]
    pc = se3.apply(Tcw_pred, mp_pos[pid])
    uv = cam_geo.project(pc, K)
    vis = has_point & (pc[:, 2] > 0.1)
    radius = radius_th * scale_factors[_i64(torch.clamp(last_octave, 0, scale_factors.shape[0] - 1))]
    res = match.search_frame_to_frame(
        last_desc, uv, last_octave, vis, last_angle,
        frame.desc, frame.xy, frame.octave, frame.valid, frame.angle,
        radius, max_dist=max_dist,
    )
    assigned = res.assigned
    cur_point = torch.where(
        assigned >= 0, last_point_idx[_i64(torch.clamp(assigned, 0, S - 1))], -1
    )
    return cur_point, uv


def reference_kf_match(kf_desc, kf_point_idx, kf_angle, kf_feat_valid, mp_valid, frame: FrameData):
    """Match the frame's descriptors against a keyframe's bound features
    (dense substitute for SearchByBoW, ratio 0.7)."""
    pid = _i64(torch.clamp(kf_point_idx, 0, mp_valid.shape[0] - 1))
    valid_a = kf_feat_valid & (kf_point_idx >= 0) & mp_valid[pid]
    res = match.search_brute(
        kf_desc, valid_a, kf_angle,
        frame.desc, frame.valid, frame.angle,
        max_dist=match.TH_LOW, ratio=0.7, check_rotation=True,
    )
    assigned = res.assigned
    return torch.where(
        assigned >= 0, kf_point_idx[_i64(torch.clamp(assigned, 0, kf_desc.shape[0] - 1))], -1
    )


def _host(*xs: torch.Tensor):
    """Read tensors back to the host, one read each (a list, or a Python
    scalar for a 0-d tensor): relocalization's host reads, the
    reference's own, all go through here."""
    out = [x.tolist() for x in xs]
    return out[0] if len(out) == 1 else out


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """`jnp.nanmedian` of a vector: the mean of the two middle values of an
    even count (`torch.nanmedian` returns the lower one), NaN when every
    entry is NaN. No host read: the sort puts NaN last."""
    v, _ = torch.sort(x)
    n = torch.sum(~torch.isnan(x)).reshape(1)
    lo = v.gather(0, torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0))[0]
    hi = v.gather(0, torch.clamp(torch.div(n, 2, rounding_mode="floor"), max=x.shape[0] - 1))[0]
    return 0.5 * lo + 0.5 * hi


def _top_k(values: torch.Tensor, k: int):
    """`lax.top_k` over the last dimension: the k largest values, ties in
    ascending index order (`torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_local_map(
    state: ms.MapState,
    cur_point_idx,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
):
    """Local keyframes = observers of the current points + top covisibles;
    local points = points bound in those keyframes, most relevant
    keyframe's points first, newest slot on ties (ORB-SLAM2
    UpdateLocalKeyFrames/UpdateLocalPoints).

    Returns (local_kf_ids [L], local_kf_mask [L] bool,
             local_point_ids [M], local_point_mask [M] bool, ref_kf)."""
    P = state.capacity_mp
    K = state.capacity_kf
    dev = cur_point_idx.device
    max_local_kfs = min(max_local_kfs, K)
    pid = _i64(torch.clamp(cur_point_idx, 0, P - 1))
    bound = (cur_point_idx >= 0) & state.mp_valid[pid]
    obs_kf = state.mp_obs_kf[pid]                     # [S, O]
    obs_ok = bound[:, None] & (obs_kf >= 0)
    votes = torch.zeros(K + 1, dtype=torch.int32, device=dev).index_add(
        0, _i64(torch.where(obs_ok, obs_kf, K)).reshape(-1),
        torch.ones(obs_kf.numel(), dtype=torch.int32, device=dev),
    )[:K]
    votes = torch.where(state.kf_valid, votes, 0)
    ref_kf = torch.argmax(votes).to(torch.int32)
    covis_boost = torch.amax(state.covis * (votes > 0)[:, None].to(torch.int32), dim=0)
    score = votes * 1000 + torch.where(votes > 0, 0, covis_boost)
    score = torch.where(state.kf_valid, score, -1)
    _, local_kfs = _top_k(score, max_local_kfs)
    local_kf_mask = score[local_kfs] > 0
    L = local_kfs.shape[0]
    ids = state.kf_point_idx[local_kfs]               # [L, S]
    ids_w = _i64(torch.where(local_kf_mask[:, None] & (ids >= 0), ids, P))
    rank_l = torch.arange(L, dtype=torch.int32, device=dev)[:, None].expand(ids_w.shape)
    pri = torch.full((P + 1,), L, dtype=torch.int32, device=dev).scatter_reduce(
        0, ids_w.reshape(-1), rank_l.reshape(-1), "amin", include_self=True
    )[:P]
    flagged = (pri < L) & state.mp_valid
    score_pt = torch.where(
        flagged, (L - pri) * (P + 1) + torch.arange(P, dtype=torch.int32, device=dev), -1
    )
    top_score, local_points = _top_k(score_pt, max_local_points)
    local_point_mask = top_score >= 0
    return local_kfs, local_kf_mask, local_points, local_point_mask, ref_kf


def search_local_points(
    state: ms.MapState,
    local_points,
    local_point_mask,
    Tcw,
    cur_point_idx,
    frame: FrameData,
    K: cam_geo.Intrinsics,
    scale_factors,
    image_bounds,
    radius_mult,
    num_levels: int = 8,
    max_dist=match.TH_HIGH,
):
    """Frustum-check local points, predict their scale and project-match
    them into the frame's unbound features (ORB-SLAM2 isInFrustum +
    SearchLocalPoints).

    Returns (merged point_idx bindings [S], visible [M] mask)."""
    pw = state.mp_pos[local_points]
    pc = se3.apply(Tcw, pw)
    uv = cam_geo.project(pc, K)
    z_ok = pc[:, 2] > 0.1
    xmin, xmax, ymin, ymax = image_bounds
    in_img = (uv[:, 0] >= xmin) & (uv[:, 0] < xmax) & (uv[:, 1] >= ymin) & (uv[:, 1] < ymax)
    rays = pw - se3.camera_center(Tcw)
    dist = torch.linalg.norm(rays, dim=-1)
    dist_ok = (dist >= state.mp_min_dist[local_points] * 0.8) & (
        dist <= state.mp_max_dist[local_points] * 1.2
    )
    viewcos = torch.sum(rays * state.mp_normal[local_points], dim=-1) / torch.clamp(dist, min=1e-9)
    visible = local_point_mask & z_ok & in_img & dist_ok & (viewcos > 0.5)

    # already-bound points are not re-matched
    P = state.capacity_mp
    bound = _i64(torch.where(cur_point_idx >= 0, cur_point_idx, P))
    # the value on the device: a Python scalar written through an index is
    # copied from the host, and the copy waits for the card
    bound_flag = torch.zeros(P + 1, dtype=torch.bool, device=pw.device).index_put_(
        (bound,), torch.ones_like(bound, dtype=torch.bool))
    visible = visible & ~bound_flag[local_points]

    # predicted octave from distance (MapPoint::PredictScale)
    ratio = state.mp_max_dist[local_points] / torch.clamp(dist, min=1e-9)
    log_scale = torch.log(scale_factors[1])
    pred_octave = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale).to(torch.int32),
        0, num_levels - 1,
    )
    r = torch.where(viewcos > 0.998, 2.5, 4.0) * radius_mult
    radius = r * scale_factors[_i64(pred_octave)]

    free_feat = frame.valid & (cur_point_idx < 0)
    res = match.search_by_projection(
        state.mp_desc[local_points], uv, pred_octave, visible,
        frame.desc, frame.xy, frame.octave, free_feat,
        radius, max_dist=max_dist, ratio=0.8,
    )
    assigned = res.assigned
    new_bind = torch.where(
        assigned >= 0,
        local_points[_i64(torch.clamp(assigned, 0, local_points.shape[0] - 1))],
        -1,
    ).to(torch.int32)
    return torch.where(cur_point_idx >= 0, cur_point_idx, new_bind), visible


def build_pose_observations(point_idx, frame: FrameData, mp_pos, mp_valid, inv_sigma2_per_octave):
    pid = _i64(torch.clamp(point_idx, 0, mp_pos.shape[0] - 1))
    return pose_opt.PoseObservations(
        pw=mp_pos[pid],
        uv=frame.xy,
        ur=frame.ur,
        inv_sigma2=inv_sigma2_per_octave[
            _i64(torch.clamp(frame.octave, 0, inv_sigma2_per_octave.shape[0] - 1))
        ],
        mask=(point_idx >= 0) & mp_valid[pid] & frame.valid,
    )


def update_seen_counters(state: ms.MapState, visible_pts, visible_mask, found_pts, found_mask) -> None:
    """mnVisible / mnFound bookkeeping, in place. Unselected entries go to
    a scratch slot P of a P+1 buffer that is then sliced off."""
    P = state.capacity_mp
    for counter, pts, sel in (
        (state.mp_visible, visible_pts, visible_mask),
        (state.mp_found, found_pts, found_mask),
    ):
        buf = torch.cat([counter, counter.new_zeros(1)])
        buf.index_add_(0, _i64(torch.where(sel, pts, P)), torch.ones_like(buf[: sel.shape[0]]))
        counter.copy_(buf[:P])


# ---------------------------------------------------------------------------
# host-side tracker
# ---------------------------------------------------------------------------


class Tracker:
    """Host orchestration of the per-frame pipeline."""

    def __init__(self, cfg: SlamConfig, builder: FrameBuilder, state: ms.MapState):
        self.cfg = cfg
        self.builder = builder
        self.device = builder.device
        self.map = state
        self.K = builder.K
        nl = cfg.orb.num_levels
        sf = cfg.orb.scale_factor
        self.scale_factors = torch.tensor([sf**i for i in range(nl)], dtype=torch.float32,
                                          device=self.device)
        self.inv_sigma2 = torch.tensor([1.0 / sf ** (2 * i) for i in range(nl)],
                                       dtype=torch.float32, device=self.device)
        self.bounds = cam_geo.compute_image_bounds(cfg.camera)
        self.state = TrackState.NOT_INITIALIZED
        self.velocity: Optional[torch.Tensor] = None
        self.last_Tcw: Optional[torch.Tensor] = None
        self.last_frame: Optional[FrameData] = None
        self.last_point_idx: Optional[torch.Tensor] = None
        self.ref_kf: int = -1
        self.frames_since_kf = 0
        self.n_keyframes = 0
        # the last tracked frame's inlier count (what a relocalized frame
        # reports, as in the reference)
        self.last_inliers = 0
        self._params = None
        self._ref_pose_np = np.eye(4)
        # set when the policy requests a keyframe; consumed by System
        self.kf_request = None
        self.new_keyframe_ids: list[int] = []
        # monocular initialization: the first frame of the pair, and the
        # CPU generator of its and relocalization's RANSAC draws (the card
        # and the CPU draw the same minimal sets)
        self.init_frame: Optional[FrameData] = None
        self.init_generator = torch.Generator().manual_seed(cfg.seed)
        # localization mode: the frame-to-frame visual odometry has taken
        # over from tracking against the frozen map (ORB-SLAM2 mbVO)
        self.mb_vo = False
        # per-frame trajectory log: (timestamp, Tcr, ref_kf, tracked)
        self.trajectory: list[tuple[float, np.ndarray, int, bool]] = []

    # -- initialization ----------------------------------------------------

    def _stereo_initialize(self, frame: FrameData) -> bool:
        """Stereo and RGB-D initialization: gate on the feature and depth-seed counts,
        insert the first keyframe at the origin and create a point for
        every feature with depth."""
        n_feat = int(torch.sum(frame.valid))
        n_depth = int(torch.sum(frame.valid & (frame.depth > 0)))
        if n_feat < self.cfg.orb.num_features // 2 or n_depth < 100:
            return False
        Tcw = se3.identity(device=self.device)
        S = frame.xy.shape[0]
        unbound = torch.full((S,), -1, dtype=torch.int32, device=self.device)
        kf0 = ms.add_keyframe(
            self.map, frame.frame_id, Tcw,
            frame.xy, frame.ur, frame.depth, frame.octave, frame.angle,
            frame.desc, frame.valid, unbound,
        )
        self._create_depth_points(self.map, kf0, frame, Tcw, unbound, all_depths=True)
        self.ref_kf = kf0
        self.last_point_idx = self.map.kf_point_idx[kf0].clone()
        self.new_keyframe_ids.append(kf0)
        self.n_keyframes = 1
        self._ref_pose_np = np.eye(4)
        return True

    def _create_depth_points(self, st: ms.MapState, kf_id: int, frame: FrameData, Tcw,
                             existing_bind, all_depths: bool = False):
        """Create map points for unbound features with valid depth: every
        one at initialization, else the close ones (depth < ThDepth *
        baseline) plus the 100 nearest."""
        th = self.cfg.tracking.th_depth * self.cfg.camera.baseline
        has_depth = frame.valid & (frame.depth > 0) & (existing_bind < 0)
        if all_depths:
            create = has_depth
        else:
            depth_rank = torch.sum(
                (frame.depth[None, :] < frame.depth[:, None]) & has_depth[None, :], dim=1
            )
            create = has_depth & ((frame.depth < th) | (depth_rank < 100))
        pc = cam_geo.backproject(frame.xy, frame.depth, self.K)
        pw = se3.apply(se3.inverse(Tcw), pc)
        rays = pw - se3.camera_center(Tcw)
        dist = torch.linalg.norm(rays, dim=-1)
        normal = rays / torch.clamp(dist[:, None], min=1e-9)
        scale = self.scale_factors[_i64(torch.clamp(frame.octave, 0, self.scale_factors.shape[0] - 1))]
        max_d = dist * scale
        min_d = max_d / float(self.cfg.orb.scale_factor ** (self.cfg.orb.num_levels - 1))
        S = frame.xy.shape[0]
        return ms.add_points(
            st, pw, create, kf_id, torch.arange(S, dtype=torch.int32, device=self.device),
            frame.desc, normal, min_d, max_d, frame.ur,
        )

    def draw_init_samples(self, mask: torch.Tensor) -> torch.Tensor:
        """The [iters, 8] minimal sets of one initialization attempt, drawn
        on the CPU (`initializer.draw_init_samples`); a test may replace
        this method to reproduce another draw."""
        return mono_init.draw_init_samples(mask, self.cfg.solver.init_ransac_iters,
                                           self.init_generator)

    def _monocular_initialize(self, frame: FrameData) -> bool:
        """Two-view bootstrap (ORB-SLAM2 MonocularInitialization and
        CreateInitialMapMonocular): the first frame with enough features
        is kept; a later frame with enough window matches to it runs the
        H/F initializer, and on success both become keyframes, with the
        map scaled to a median depth of 1."""
        min_m = self.cfg.tracking.mono_init_min_matches
        n_feat = int(torch.sum(frame.valid))
        if self.init_frame is None:
            if n_feat > min_m:
                self.init_frame = frame
            return False
        f0 = self.init_frame
        res = match.search_for_initialization(
            f0.desc, f0.xy, f0.octave, f0.valid, f0.angle,
            frame.desc, frame.xy, frame.octave, frame.valid, frame.angle,
            max_level=self.cfg.orb.num_levels - 1,
        )
        n = int(res.num_matches)
        if n < min_m:
            self.init_frame = frame if n_feat >= min_m else None
            return False
        # align the matches: per f0 slot, the frame's slot
        S = frame.xy.shape[0]
        matched = res.best_idx >= 0
        f2c = torch.clamp(res.best_idx, 0, S - 1)
        init = mono_init.initialize(
            f0.xy, frame.xy[_i64(f2c)], matched, self.K, self.draw_init_samples(matched),
            sigma=self.cfg.solver.init_sigma,
        )
        if not bool(init.success):
            return False
        good = init.good & matched
        if int(torch.sum(good)) < min_m:
            return False
        # median-depth scale normalization
        med = _nanmedian(torch.where(good, init.points3d[:, 2], float("nan")))
        inv_med = 1.0 / torch.clamp(med, min=1e-6)
        pts = init.points3d * inv_med
        T21 = init.T21.clone()
        T21[:3, 3] *= inv_med

        unbound = torch.full((S,), -1, dtype=torch.int32, device=self.device)
        kf0 = ms.add_keyframe(
            self.map, f0.frame_id, se3.identity(device=self.device),
            f0.xy, f0.ur, f0.depth, f0.octave, f0.angle, f0.desc, f0.valid, unbound,
        )
        kf1 = ms.add_keyframe(
            self.map, frame.frame_id, T21,
            frame.xy, frame.ur, frame.depth, frame.octave, frame.angle, frame.desc,
            frame.valid, unbound,
        )
        # points seeded in kf0's feature slots, then bound to kf1
        dist = torch.linalg.norm(pts, dim=-1)
        normal = pts / torch.clamp(dist[:, None], min=1e-9)
        nl = self.cfg.orb.num_levels
        max_d = dist * self.scale_factors[_i64(torch.clamp(f0.octave, 0, nl - 1))]
        min_d = max_d / float(self.cfg.orb.scale_factor ** (nl - 1))
        pids = ms.add_points(
            self.map, pts, good, kf0, torch.arange(S, dtype=torch.int32, device=self.device),
            f0.desc, normal, min_d, max_d, torch.full((S,), -1.0, device=self.device),
        )
        from orbslam2_tpu_torch.pipeline import local_mapping as lm

        lm.bind_points_to_kf(self.map, kf1, f2c.to(torch.int32), pids, pids >= 0)
        ms.update_covisibility_row(self.map, kf1)
        ms.recompute_point_stats(self.map, pids, self.scale_factors)
        self.ref_kf = kf1
        self.last_Tcw = T21
        self.last_point_idx = self.map.kf_point_idx[kf1].clone()
        self.new_keyframe_ids.extend([kf0, kf1])
        self.n_keyframes = 2
        self._ref_pose_np = T21.cpu().numpy()
        return True

    # -- localization-mode dual hypothesis (ORB-SLAM2 mbVO) ----------------

    def localization_vo_step(self, frame: FrameData, reloc_db) -> TrackResult:
        """Localization-mode tracking once the frozen map is out of view
        (ORB-SLAM2 Tracking::Track, mbVO): relocalization against the map
        is tried first on every frame and wins when it succeeds; otherwise
        the pose follows `visual_odometry` from the last frame (its
        features backprojected from their depth are UpdateLastFrame's
        temporary points). Nothing is written to the map."""
        if self.relocalize(frame, reloc_db):
            self.mb_vo = False
            Tcw_np = self.last_Tcw.cpu().numpy()
            self._log_pose(frame, True, Tcw_np)
            self.last_inliers = max(self.last_inliers, 50)
            return TrackResult(Tcw_np, self.state, self.last_inliers, False)

        self.mb_vo = True
        Tcw_pred, r = self.visual_odometry(frame, self.last_frame, self.last_Tcw, self.velocity)
        n_inl = _host(r.num_inliers)
        ok = n_inl >= self.cfg.tracking.min_inliers_track
        Tcw = r.Tcw if ok else Tcw_pred
        self.velocity = Tcw @ se3.inverse(self.last_Tcw)
        self.last_Tcw = Tcw
        self.last_frame = frame
        self.last_point_idx = torch.full_like(frame.octave, -1)
        self.last_inliers = n_inl
        self.state = TrackState.OK if ok else TrackState.LOST
        Tcw_np = Tcw.cpu().numpy()
        self._log_pose(frame, ok, Tcw_np)
        return TrackResult(Tcw_np, self.state, n_inl, False)

    def visual_odometry(self, frame: FrameData, last_frame: FrameData, last_Tcw: torch.Tensor,
                        velocity: Optional[torch.Tensor]):
        """One step of the frame-to-frame visual odometry from the given
        state, which it does not change: `last_frame`'s features with depth
        backprojected at `last_Tcw`, predicted into `frame` by the motion
        model, matched by `search_frame_to_frame` (K1 through
        `match_gated`) and refined by the 4x10 robust pose optimisation.
        The reference calls the plain `pose_opt.pose_optimize` there; the
        port calls `pose_optimize_fast`, which on a CUDA tensor is K2 and
        on a CPU tensor that plain version, the same schedule either way.
        Returns (the predicted Tcw, the optimisation's result)."""
        dev = self.device
        if velocity is None:
            velocity = torch.eye(4, device=dev)
        Tcw_pred = velocity @ last_Tcw
        lf = last_frame
        pc = cam_geo.backproject(lf.xy, lf.depth, self.K)
        pw = se3.apply(se3.inverse(last_Tcw), pc)
        has = lf.valid & (lf.depth > 0)
        pc_pred = se3.apply(Tcw_pred, pw)
        uv_pred = cam_geo.project(pc_pred, self.K)
        nl = self.scale_factors.shape[0]
        radius = 14.0 * self.scale_factors[_i64(torch.clamp(lf.octave, 0, nl - 1))]
        res = match.search_frame_to_frame(
            lf.desc, uv_pred, lf.octave, has & (pc_pred[:, 2] > 0.1), lf.angle,
            frame.desc, frame.xy, frame.octave, frame.valid, frame.angle,
            radius, max_dist=self.cfg.tracking.match_max_dist,
        )
        assigned = res.assigned
        S = assigned.shape[0]
        obs = pose_opt.PoseObservations(
            pw=pw[_i64(torch.clamp(assigned, 0, S - 1))],
            uv=frame.xy,
            ur=frame.ur,
            inv_sigma2=self.inv_sigma2[_i64(torch.clamp(frame.octave, 0, nl - 1))],
            mask=(assigned >= 0) & frame.valid,
        )
        return Tcw_pred, pose_optimize_fast(Tcw_pred, obs, self.K)

    # -- relocalization ----------------------------------------------------

    def warmup_reloc(self, db) -> None:
        """Run every stage of `relocalize` once, on a dummy frame with no
        valid feature against the map (no stage writes to it), and discard
        the results (the reference's `warmup_reloc`, which compiles the
        same chain): the BoW query, a keyframe match, the EPnP RANSAC on draws
        from a scratch generator, the pose optimisation and a projection
        search. What it moves off the first relocalizing frame is
        first-use cost (kernel and library loads). The tracker's generator,
        its state and the map are untouched."""
        if db is None:
            return
        st = self.map
        S = self.cfg.orb.feature_slots
        dev = self.device
        f = FrameData(
            frame_id=0, timestamp=0.0,
            xy=torch.zeros((S, 2), device=dev),
            xy_raw=torch.zeros((S, 2), device=dev),
            ur=torch.full((S,), -1.0, device=dev),
            depth=torch.full((S,), -1.0, device=dev),
            octave=torch.zeros((S,), dtype=torch.int32, device=dev),
            angle=torch.zeros((S,), device=dev),
            desc=torch.zeros((S, 8), dtype=torch.int32, device=dev),
            valid=torch.zeros((S,), dtype=torch.bool, device=dev),
        )
        vec = bow.bow_vector(f.desc, f.valid, db.codebook)
        db.query(vec, ~st.kf_valid, 0.0, st.covis)
        bind = reference_kf_match(st.kf_desc[0], st.kf_point_idx[0], st.kf_angle[0],
                                  st.kf_feat_valid[0], st.mp_valid, f)
        pid = _i64(torch.clamp(bind, 0, st.capacity_mp - 1))
        mask = (bind >= 0) & st.mp_valid[pid]
        oct_c = _i64(torch.clamp(f.octave, 0, self.inv_sigma2.shape[0] - 1))
        scratch = torch.Generator().manual_seed(0)
        epnp.ransac_pnp(st.mp_pos[pid], f.xy, mask, self.inv_sigma2[oct_c], self.K,
                        epnp.draw_pnp_samples(mask, self.cfg.solver.pnp_ransac_iters, scratch),
                        min_inliers=self.cfg.solver.pnp_min_inliers)
        obs = build_pose_observations(bind, f, st.mp_pos, st.mp_valid, self.inv_sigma2)
        res = pose_optimize_fast(st.kf_Tcw[0], obs, self.K)
        _, _, lpts, lptsm, _ = gather_local_map(
            st, st.kf_point_idx[0], max_local_kfs=self.cfg.map.max_local_keyframes,
            max_local_points=self.cfg.map.max_local_points)
        search_local_points(st, lpts, lptsm, res.Tcw, bind, f, self.K, self.scale_factors,
                            self.bounds, 2.5, num_levels=self.cfg.orb.num_levels)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def draw_pnp_samples(self, mask: torch.Tensor) -> torch.Tensor:
        """The [iters, 6] minimal sets of one EPnP RANSAC, from the
        tracker's CPU generator; a test may replace this method to
        reproduce another draw."""
        return epnp.draw_pnp_samples(mask, self.cfg.solver.pnp_ransac_iters,
                                     self.init_generator)

    def relocalize(self, frame: FrameData, db) -> bool:
        """Recover from LOST through the keyframe database (ORB-SLAM2
        Tracking::Relocalization): for each of the best 5 candidates, a
        brute match to its bound features, EPnP RANSAC for the initial
        pose (the candidate's own pose if it fails), robust pose
        optimisation, then the escalating projection search until >= 50
        inliers. The host reads are the reference's: the candidate list,
        and per candidate the match count, the RANSAC's success and the two
        inlier counts, each through `_host`, and the reference pose's on
        success."""
        if db is None:
            return False
        st = self.map
        cfg = self.cfg
        # the query vector carries no idf, as in the reference
        vec = bow.bow_vector(frame.desc, frame.valid, db.codebook)
        # no covisibility exclusion and no min score, but the same
        # top-10 covisibility-group accumulation as loop detection; culled
        # slots whose row lingers are excluded
        cand, mask, _ = db.query(vec, ~st.kf_valid, 0.0, st.covis)
        cands = [c for c, m in zip(*_host(cand, mask)) if m][:5]
        P = st.capacity_mp
        oct_c = _i64(torch.clamp(frame.octave, 0, self.inv_sigma2.shape[0] - 1))
        for c in cands:
            bind = reference_kf_match(st.kf_desc[c], st.kf_point_idx[c], st.kf_angle[c],
                                      st.kf_feat_valid[c], st.mp_valid, frame)
            if _host(torch.sum(bind >= 0)) < cfg.tracking.min_matches_ref:
                continue
            pid = _i64(torch.clamp(bind, 0, P - 1))
            pnp_mask = (bind >= 0) & st.mp_valid[pid]
            pnp = epnp.ransac_pnp(st.mp_pos[pid], frame.xy, pnp_mask, self.inv_sigma2[oct_c], self.K,
                                  self.draw_pnp_samples(pnp_mask),
                                  min_inliers=cfg.solver.pnp_min_inliers)
            T_init = pnp.Tcw if _host(pnp.success) else st.kf_Tcw[c]
            obs = build_pose_observations(bind, frame, st.mp_pos, st.mp_valid, self.inv_sigma2)
            res = pose_optimize_fast(T_init, obs, self.K)
            if _host(res.num_inliers) < cfg.tracking.min_inliers_track:
                continue
            Tcw = res.Tcw
            bind = torch.where(res.inliers, bind, -1)
            # escalating projection search
            _, _, lpts, lptsm, _ = gather_local_map(
                st, st.kf_point_idx[c], max_local_kfs=cfg.map.max_local_keyframes,
                max_local_points=cfg.map.max_local_points)
            for radius_mult in (2.5, 1.0):
                bind, _ = search_local_points(st, lpts, lptsm, Tcw, bind, frame, self.K,
                                              self.scale_factors, self.bounds, radius_mult,
                                              num_levels=cfg.orb.num_levels)
                obs = build_pose_observations(bind, frame, st.mp_pos, st.mp_valid,
                                              self.inv_sigma2)
                res = pose_optimize_fast(Tcw, obs, self.K)
                Tcw = res.Tcw
                bind = torch.where(res.inliers, bind, -1)
            if _host(res.num_inliers) >= cfg.tracking.min_inliers_local_after_reloc:
                self.state = TrackState.OK
                self.last_Tcw = Tcw
                self.last_frame = frame
                self.last_point_idx = bind
                self.velocity = None
                self.ref_kf = c
                self.refresh_ref_pose()
                return True
        return False

    # -- main entry --------------------------------------------------------

    def process(self, frame: FrameData, reloc_db=None) -> TrackResult:
        """One frame through the state machine (the synchronous path;
        steady-state frames go through System's dispatch). A LOST tracker
        relocalizes against `reloc_db`, the loop closer's database."""
        if self.state == TrackState.LOST:
            if self.relocalize(frame, reloc_db):
                Tcw_np = self.last_Tcw.cpu().numpy()
                self._log_pose(frame, True, Tcw_np)
                return TrackResult(Tcw_np, self.state, self.last_inliers, False)
            self._log_pose(frame, False)
            Tcw = self.last_Tcw.cpu().numpy() if self.last_Tcw is not None else np.eye(4)
            return TrackResult(Tcw, self.state, 0, False)
        if self.state == TrackState.NOT_INITIALIZED:
            if self.cfg.sensor in (Sensor.STEREO, Sensor.RGBD):
                if self._stereo_initialize(frame):
                    self.state = TrackState.OK
                    self.last_Tcw = se3.identity(device=self.device)
                    self.last_frame = frame
                    self.frames_since_kf = 0
                    self._log_pose(frame, True)
                    return TrackResult(np.eye(4), self.state, 0, True)
            elif self._monocular_initialize(frame):
                self.state = TrackState.OK
                self.last_frame = frame
                self.frames_since_kf = 0
                Tcw_np = self.last_Tcw.cpu().numpy()
                self._log_pose(frame, True, Tcw_np)
                return TrackResult(Tcw_np, self.state, 0, True)
            self._log_pose(frame, False)
            return TrackResult(np.eye(4), TrackState.NOT_INITIALIZED, 0, False)

        from orbslam2_tpu_torch.pipeline import fused

        out = fused.track_step(self.map, frame, *self._anchors(), **self._track_sizes())
        return self._finish(frame, out)

    def _ensure_params(self):
        if self._params is not None:
            return
        from orbslam2_tpu_torch.pipeline import fused

        radius_th = 7.0 if self.cfg.sensor != Sensor.MONOCULAR else 15.0
        if self.cfg.tracking.search_radius > 0:
            radius_th = float(self.cfg.tracking.search_radius)
        self._params = fused.TrackParams(
            scale_factors=self.scale_factors,
            inv_sigma2=self.inv_sigma2,
            bounds=self.bounds,
            radius_th=radius_th,
            min_track=self.cfg.tracking.min_inliers_track,
            close_depth=self.cfg.tracking.th_depth * self.cfg.camera.baseline,
            min_track_local=self.cfg.tracking.min_inliers_local,
            match_max_dist=self.cfg.tracking.match_max_dist,
        )

    def process_rgbd_fast(self, image, depth_map, timestamp: float) -> TrackResult:
        """One RGB-D frame as one call: extraction, depth seeding and the
        track step (`fused.track_frame_rgbd`), for a tracker in state OK."""
        from orbslam2_tpu_torch.pipeline import fused

        frame, out = fused.track_frame_rgbd(
            self.map, self.builder.extractor, self._as_tensor(image), self._as_tensor(depth_map),
            self.builder._fresh_id(), *self._anchors(), 1.0 / self.cfg.tracking.depth_map_factor,
            has_distortion=self.cfg.camera.has_distortion(), **self._track_sizes(),
        )
        return self._finish(frame._replace(timestamp=timestamp), out)

    def process_stereo_fast(self, left, right, timestamp: float) -> TrackResult:
        """One stereo frame as one call: extraction of both images, the
        stereo match and the track step (`fused.track_frame_stereo`), for a
        tracker in state OK."""
        from orbslam2_tpu_torch.pipeline import fused

        frame, out = fused.track_frame_stereo(
            self.map, self.builder.extractor, self._as_tensor(left), self._as_tensor(right),
            self.builder._fresh_id(), *self._anchors(),
            has_distortion=self.cfg.camera.has_distortion(), **self._track_sizes(),
        )
        return self._finish(frame._replace(timestamp=timestamp), out)

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _anchors(self) -> tuple:
        """The track step's arguments from the last frame to the params:
        the last frame's features and bindings, its pose, the motion model
        (identity without one), the reference keyframe."""
        self._ensure_params()
        f = self.last_frame
        has_velocity = self.velocity is not None
        velocity = self.velocity if has_velocity else torch.eye(4, device=self.device)
        return (f.xy, self.last_point_idx, f.octave, f.angle, f.desc, self.last_Tcw, velocity,
                has_velocity, self.ref_kf, self.K, self._params)

    def _track_sizes(self) -> dict:
        return dict(max_local_kfs=self.cfg.map.max_local_keyframes,
                    max_local_points=self.cfg.map.max_local_points,
                    num_levels=self.cfg.orb.num_levels)

    def _finish(self, frame: FrameData, out) -> TrackResult:
        """The host half of a tracked frame (`process` and the single-call
        steps): one read of the pose and the five scalars the policy needs,
        the LOST gate, the motion model and the keyframe policy. Pose and
        scalars come back in one float64 read, which holds the counts and
        the float32 pose exactly."""
        flags = torch.stack([out.ok, out.n_inliers, out.ref_tracked, out.close_tracked,
                             out.close_free]).to(torch.float64)
        host = torch.cat([flags, out.Tcw.reshape(-1).to(torch.float64)]).tolist()
        ok, n_inliers, ref_tracked, close_t, close_f = (int(v) for v in host[:5])
        Tcw_np = np.asarray(host[5:], np.float32).reshape(4, 4)
        if not ok or n_inliers < self.cfg.tracking.min_inliers_local:
            self.state = TrackState.LOST
            self.velocity = None
            self._log_pose(frame, False)
            return TrackResult(Tcw_np, self.state, n_inliers, False)

        self.state = TrackState.OK
        self.velocity = out.Tcw @ se3.inverse(self.last_Tcw)
        is_kf = self._need_new_keyframe(n_inliers, ref_tracked, close_t, close_f)
        if is_kf:
            self.kf_request = (frame, out.Tcw, out.point_idx)
            self.frames_since_kf = 0
        else:
            self.frames_since_kf += 1
        self.last_Tcw = out.Tcw
        self.last_frame = frame
        self.last_point_idx = out.point_idx
        self.last_inliers = n_inliers
        self._log_pose(frame, True, Tcw_np)
        return TrackResult(Tcw_np, self.state, n_inliers, is_kf)

    # -- keyframe policy ---------------------------------------------------

    def _need_new_keyframe(self, n_inliers, ref_tracked, close_tracked, close_free) -> bool:
        """Condensed ORB-SLAM2 NeedNewKeyFrame, fed by scalars computed in
        the track step."""
        min_gap = self.cfg.tracking.kf_min_gap
        max_gap = max(int(self.cfg.camera.fps) // 2, 5)
        ratio = 0.75 if self.cfg.sensor != Sensor.MONOCULAR else 0.9
        if self.n_keyframes <= 2:
            ratio = 0.4
        need_ratio = n_inliers < ratio * max(ref_tracked, 1)
        close_cond = (
            self.cfg.sensor != Sensor.MONOCULAR and close_tracked < 100 and close_free > 70
        )
        c1 = self.frames_since_kf >= max_gap
        c2 = (need_ratio or close_cond) and self.frames_since_kf >= min_gap
        return (c1 or c2) and n_inliers > 15

    def on_new_keyframe(self, kf_id: int, ref_pose_np=None):
        """Bookkeeping after a keyframe was inserted."""
        self.ref_kf = kf_id
        self.n_keyframes += 1
        self.new_keyframe_ids.append(kf_id)
        if ref_pose_np is not None:
            self._ref_pose_np = np.asarray(ref_pose_np)
        else:
            self.refresh_ref_pose()

    def refresh_ref_pose(self):
        """Pull the reference keyframe's current pose to the host (poses
        are logged relative to it; BA moves keyframes). A copy: on the CPU
        `.numpy()` would share the map's storage, and a pipelined session
        moves the keyframe in place before the frames dispatched earlier
        are logged against this pose."""
        if self.ref_kf >= 0:
            self._ref_pose_np = self.map.kf_Tcw[self.ref_kf].cpu().numpy().copy()

    def remap_trajectory_ref(self, old_ref: int, new_ref: int, Tcp: np.ndarray):
        """Re-anchor logged frames from a culled keyframe to its spanning-
        tree parent: Tcw = Tcr @ Tcw[culled] = (Tcr @ Tcp) @ Tcw[parent].
        ORB-SLAM2 keeps mTcp on SetBadFlag and walks the tree at export
        time; folding it in at cull time is equivalent."""
        self.trajectory = [
            (t, Tcr @ Tcp, new_ref, ok) if ref == old_ref else (t, Tcr, ref, ok)
            for (t, Tcr, ref, ok) in self.trajectory
        ]

    # -- logging -----------------------------------------------------------

    def _log_pose(self, frame: FrameData, tracked: bool, Tcw=None):
        """Log the pose relative to the current reference keyframe
        (Tcr = Tcw * Trw^-1), so the trajectory follows later corrections
        of keyframe poses. Host math against the cached reference pose."""
        if Tcw is not None:
            T = np.asarray(Tcw)
        elif self.last_Tcw is not None:
            T = self.last_Tcw.cpu().numpy()
        else:
            T = np.eye(4)
        if not np.isfinite(T).all():
            T = self.trajectory[-1][1] @ self._ref_pose_np if (
                self.trajectory and self.trajectory[-1][2] == self.ref_kf
            ) else np.eye(4)
            tracked = False
        if self.ref_kf >= 0 and np.isfinite(self._ref_pose_np).all():
            Tcr = T @ np.linalg.inv(self._ref_pose_np)
        else:
            Tcr = T
        self.trajectory.append((frame.timestamp, Tcr, self.ref_kf, tracked))
