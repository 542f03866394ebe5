"""Public session API for any sensor (RGB-D, stereo, monocular): the port
of `orbslam2_tpu.pipeline.system.System`, with tracking, local mapping,
relocalization, loop closing and localization mode.

Until the map is initialised (one frame for RGB-D and stereo, a two-view
bootstrap for mono), and while tracking is LOST (relocalization), each
frame goes through `Tracker.process`; every other frame is dispatched
through `fused.frame_and_keyframe_step` (frame build, tracking, the
keyframe decision and, on a keyframe, insertion, mapping and local BA)
and then resolved on the host: the pose is logged, and on a keyframe the
mapper's bookkeeping runs and the loop detection is dispatched. Loop closing follows the reference's schedule: the resolve of
each frame first advances the loop closer by one step (a pending
verification, else a pending detection) and the global BA by one slice.
With `cfg.tracking.pipeline_depth` N >= 1 the resolves are a depth-N FIFO,
as in the reference: each frame is resolved N frames after its dispatch,
so the keyframe bookkeeping, the loop closer's steps and the tracker's
keyframe count run N frames late, like ORB-SLAM2's LocalMapping and
LoopClosing threads, and each dispatch chains off the previous dispatch's
anchors. (The step still decides on one host read; only the resolve is
deferred.) With `cfg.tracking.defer_local_ba` the keyframe step skips
local BA and the resolve of the keyframe runs it. In localization mode the
map is frozen: no keyframe is made and no reset wipes the map; each
accepted frame hands the reference to the keyframe that observes most of
its tracked points once the reference observes fewer than half as many
(ORB-SLAM2's UpdateLocalKeyFrames), and an
RGB-D frame that loses the map but still tracks coarsely hands over to
frame-to-frame visual odometry (mbVO) until a relocalization succeeds.
Without a vocabulary file the session trains its own at its first mapped
keyframe and retrains it as the map grows, as the reference.
Trajectories export as TUM or KITTI; the map saves to and loads from the
reference's `.npz` layout, BoW database included.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from orbslam2_tpu_torch.config import SlamConfig, Sensor
from orbslam2_tpu_torch import trajectory as traj_io
from orbslam2_tpu_torch.eventlog import EventLog
from orbslam2_tpu_torch import convert, kernels, profiling
from orbslam2_tpu_torch.pipeline import fused
from orbslam2_tpu_torch.pipeline.frame import FrameBuilder, FrameData
from orbslam2_tpu_torch.pipeline.local_mapping import LocalMapper
from orbslam2_tpu_torch.pipeline.loop_closing import LoopCloser
from orbslam2_tpu_torch.pipeline.tracking import Tracker, TrackResult, TrackState
from orbslam2_tpu_torch.slam_map import map_state as ms
from orbslam2_tpu_torch.vocab import bow


# the frame kind `fused.frame_and_keyframe_step` builds for each sensor
_FRAME_KIND = {Sensor.RGBD: "rgbd", Sensor.STEREO: "stereo", Sensor.MONOCULAR: "mono"}


class _TurboRec:
    """A dispatched steady-state frame awaiting its resolve: the step's
    results, the frame, the raw inputs (an invalidated dispatch is
    reprocessed from them on the exact path), the tracker anchors before
    it, the map epoch at dispatch (a result from a replaced map is never
    folded into the new one), the probation-window snapshot `window_keep`
    indexes, and on a keyframe the host copies of its outputs (kf_Tcw,
    window_keep, new_pids, cull_ids, cull_red) with the CUDA event that
    marks them landed (None on the CPU)."""

    __slots__ = ("res", "frame", "inputs", "prev_anchors", "epoch", "window_ids", "kf_out",
                 "landed")

    def __init__(self, res, frame, inputs, prev_anchors, epoch, window_ids, kf_out, landed):
        self.res = res
        self.frame = frame
        self.inputs = inputs
        self.prev_anchors = prev_anchors
        self.epoch = epoch
        self.window_ids = window_ids
        self.kf_out = kf_out
        self.landed = landed

    def keyframe_outputs(self) -> list[np.ndarray]:
        """The keyframe outputs on the host, once their copies landed."""
        if self.landed is not None:
            self.landed.synchronize()
        return [x.numpy() for x in self.kf_out]


def _start_host_copies(tensors, device):
    """Host copies of `tensors`, started now: on the card non-blocking
    copies into pinned memory and the event recorded after them; on the
    CPU plain copies and no event."""
    if device.type != "cuda":
        return [x.clone() for x in tensors], None
    out = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in tensors]
    for o, x in zip(out, tensors):
        o.copy_(x, non_blocking=True)
    landed = torch.cuda.Event()
    landed.record()
    return out, landed


class System:
    """One SLAM session on `device`.

    Usage:
        slam = System(cfg, device="cuda", enable_mapping=True,
                      enable_loop_closing=True)
        for image, depth, t in frames:
            Tcw = slam.track_rgbd(image, depth, t)
        slam.save_trajectory_tum("out.txt")

    `track_stereo(left, right, t)` and `track_monocular(image, t)` take the
    place of `track_rgbd` for `cfg.sensor` STEREO and MONOCULAR.
    """

    def __init__(
        self,
        cfg: SlamConfig,
        device="cuda",
        enable_mapping: bool = True,
        enable_loop_closing: bool = True,
        log_path: Optional[str] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and cfg.orb.feature_slots > kernels.POSE_GN_MAX_SLOTS:
            raise ValueError(f"feature_slots {cfg.orb.feature_slots}: the pose kernel takes at "
                             f"most {kernels.POSE_GN_MAX_SLOTS}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("System(device='cuda'): no CUDA device is available")
        # the counterpart of the reference's "highest" matmul precision:
        # SE(3) chains and normal equations need full float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.frame_kind = _FRAME_KIND[cfg.sensor]
        self.log = EventLog(log_path)
        self.enable_mapping = enable_mapping
        self.enable_loop_closing = enable_loop_closing
        self.localization_only = False
        self.builder = FrameBuilder(cfg, self.device)
        self.map = ms.allocate(cfg.map, cfg.orb, self.device)
        self.tracker = Tracker(cfg, self.builder, self.map)
        self.local_mapper = LocalMapper(cfg, self.builder.K, self.tracker.bounds, self.device)
        self.results: list[TrackResult] = []
        # made at the first keyframe that reaches it, with the vocabulary
        self.loop_closer: Optional[LoopCloser] = None
        # the depth-N FIFO of dispatched frames awaiting their resolve, and
        # the anchors (velocity, has_velocity, ref_kf, frames_since_kf) the
        # last dispatch selected for the next; None: take the tracker's
        self._pending: list[_TurboRec] = []
        self._anchor = None
        # bumped whenever the map is replaced (reset, load_map)
        self._map_epoch = 0
        # (map epoch, keyframe poses) of the frozen map in localization mode
        self._frozen_poses = (None, None)

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _kf_kwargs(self) -> dict:
        """The keyframe step's settings, as the reference's dispatch passes
        them: a monocular keyframe seeds no points from depth."""
        cfg = self.cfg
        sc = cfg.solver
        return dict(
            create_close_points=cfg.sensor != Sensor.MONOCULAR,
            scale_factor_last=float(cfg.orb.scale_factor ** (cfg.orb.num_levels - 1)),
            baseline=float(cfg.camera.baseline),
            covis_threshold=cfg.map.covis_threshold,
            n_neighbors=5,
            num_levels=cfg.orb.num_levels,
            max_local=sc.ba_max_local_kfs,
            max_fixed=sc.ba_max_fixed_kfs,
            max_points=sc.ba_max_points,
            obs_slots=min(sc.ba_max_obs_per_point, self.map.obs_slots),
            iters1=sc.local_ba_iters_first,
            iters2=sc.local_ba_iters_second,
            recycle_min_age=cfg.map.recycle_min_age_kfs,
        )

    # -- per-frame entry ---------------------------------------------------

    def track_rgbd(self, image, depth, timestamp: float = 0.0) -> np.ndarray:
        """Track one RGB-D frame (grayscale image and depth map, [H, W]);
        returns its pose Tcw as a 4x4 numpy array."""
        return self._track_sensor(Sensor.RGBD, image, depth, timestamp)

    def track_stereo(self, left, right, timestamp: float = 0.0) -> np.ndarray:
        """Track one rectified stereo pair (grayscale [H, W] each)."""
        return self._track_sensor(Sensor.STEREO, left, right, timestamp)

    def track_monocular(self, image, timestamp: float = 0.0) -> np.ndarray:
        """Track one monocular frame (grayscale [H, W])."""
        return self._track_sensor(Sensor.MONOCULAR, image, None, timestamp)

    def _track_sensor(self, sensor: Sensor, a, b, timestamp: float) -> np.ndarray:
        if sensor != self.cfg.sensor:
            raise ValueError(f"a {sensor.name} frame in a {self.cfg.sensor.name} session")
        # the id the frame is about to be given, for the spans of this call
        with profiling.span("frame", frame_id=self.builder._next_id):
            a = self._as_tensor(a)
            b = None if b is None else self._as_tensor(b)
            t = self.tracker
            if self.localization_only:
                profiling.count("localization.frames")
            if (sensor == Sensor.RGBD and self.localization_only and t.last_frame is not None
                    and (t.mb_vo or t.state == TrackState.LOST)):
                return self._track_localization_vo(self._build_frame(a, b, timestamp))
            if t.state == TrackState.OK:
                return self._track_turbo(a, b, timestamp)
            return self._track(self._build_frame(a, b, timestamp))

    def _track_localization_vo(self, frame: FrameData) -> np.ndarray:
        """An RGB-D frame in localization mode while the visual odometry
        has the pose, or tracking is lost: relocalize against the frozen
        map, else odometry from the last frame (ORB-SLAM2's mbVO)."""
        reloc_db = self.loop_closer.db if self.loop_closer is not None else None
        res = self.tracker.localization_vo_step(frame, reloc_db)
        self.results.append(res)
        self.log.emit("frame", frame_id=int(frame.frame_id), t=float(frame.timestamp),
                      state="VO" if self.tracker.mb_vo else res.state.name,
                      n_inliers=int(res.num_inliers), is_kf=False)
        return res.Tcw

    def _build_frame(self, a, b, timestamp: float) -> FrameData:
        if self.cfg.sensor == Sensor.MONOCULAR:
            return self.builder.monocular(a, timestamp)
        build = self.builder.stereo if self.cfg.sensor == Sensor.STEREO else self.builder.rgbd
        return build(a, b, timestamp)

    def _track_turbo(self, a, b, timestamp: float) -> np.ndarray:
        """Steady-state frame (any sensor): dispatch the frame step, then
        resolve it now or, pipelined, N frames later. `a` / `b` are (image,
        depth) for RGB-D, (left, right) for stereo and (image, None) for
        monocular.

        Pipelining is on at depth N >= 1 once the map has a keyframe,
        outside localization mode. A resolve that finds a loop correction
        or a global-BA fold-in resolves the frames still in flight against
        the reference poses they were dispatched with, then re-anchors
        tracking (`_absorb_pending`); one that finds the frame lost
        reprocesses the frames dispatched after it, which chained off its
        bad pose, on the exact path (`_reprocess_stale`). Returns the pose
        of the newest frame resolved or, pipelined, dispatched."""
        rec = self._turbo_dispatch(a, b, timestamp)
        depth = self.cfg.tracking.pipeline_depth
        if not (depth >= 1 and not self.localization_only and self.tracker.n_keyframes >= 1):
            while self._pending:  # draining out of pipelined mode
                ev = self._turbo_resolve(self._pending.pop(0))
                if ev == "loop":
                    self._absorb_pending(extra=rec)
                    return self.results[-1].Tcw
                if ev == "lost":
                    self._anchor = None
                    return self._reprocess_stale(extra=rec)
            if self._turbo_resolve(rec) == "loop":
                self._absorb_pending()
            return self.results[-1].Tcw
        self._pending.append(rec)
        while len(self._pending) > depth:
            ev = self._turbo_resolve(self._pending.pop(0))
            if ev == "loop":
                self._absorb_pending()
                return self.results[-1].Tcw
            if ev == "lost":
                self._anchor = None
                return self._reprocess_stale()
        return rec.res.pose

    def _turbo_dispatch(self, a, b, timestamp: float) -> _TurboRec:
        t = self.tracker
        cfg = self.cfg
        mapper = self.local_mapper
        t._ensure_params()
        fid = self.builder._fresh_id()
        # the window snapshot `window_keep` will be computed against
        window = mapper.probation_window()
        if self._anchor is not None:
            velocity, has_velocity, ref_kf, frames_since_kf = self._anchor
        else:
            velocity = t.velocity if t.velocity is not None else torch.eye(4, device=self.device)
            has_velocity, ref_kf, frames_since_kf = t.velocity is not None, t.ref_kf, t.frames_since_kf
        frame, res = fused.frame_and_keyframe_step(
            self.map, self.builder.extractor, a, b, fid,
            t.last_frame.xy, t.last_point_idx,
            t.last_frame.octave, t.last_frame.angle, t.last_frame.desc,
            t.last_Tcw, velocity, has_velocity, ref_kf, frames_since_kf, t.n_keyframes,
            self.enable_mapping and not self.localization_only, window, t.K, t._params,
            1.0 / cfg.tracking.depth_map_factor,
            mapper.level_sigma2, mapper.inv_sigma2,
            max_local_kfs=cfg.map.max_local_keyframes,
            max_local_points=cfg.map.max_local_points,
            has_distortion=cfg.camera.has_distortion(),
            max_gap=(cfg.tracking.kf_max_gap or max(int(cfg.camera.fps) // 2, 5)),
            min_gap=cfg.tracking.kf_min_gap,
            kf_ratio=0.75 if cfg.sensor != Sensor.MONOCULAR else 0.9,
            use_close_cond=cfg.sensor != Sensor.MONOCULAR,
            sensor=self.frame_kind,
            defer_ba=cfg.tracking.defer_local_ba,
            **self._kf_kwargs(),
        )
        frame = frame._replace(frame_id=fid, timestamp=timestamp)
        prev_anchors = (t.last_frame, t.last_point_idx, t.last_Tcw)
        # the next dispatch chains off this one's results, resolved or not
        t.last_frame = frame
        t.last_point_idx = res.next_point_idx
        t.last_Tcw = res.next_Tcw
        self._anchor = (res.next_velocity, res.accept, self._next_ref_kf(res),
                        res.next_frames_since_kf)
        kf_out, landed = [], None
        if res.is_kf:
            kf_out, landed = _start_host_copies(
                (res.kf_Tcw, res.window_keep, res.new_pids, res.cull_ids, res.cull_red),
                self.device)
        return _TurboRec(res, frame, (a, b, timestamp), prev_anchors, self._map_epoch, window,
                         kf_out, landed)

    def _next_ref_kf(self, res) -> int:
        """The reference keyframe of the frame after `res`: the step's. In
        localization mode, where no new keyframe ever takes over, an
        accepted frame hands the reference to the keyframe that observes
        most of its tracked points once the reference observes fewer than
        half as many, as ORB-SLAM2's UpdateLocalKeyFrames makes that
        keyframe the reference every frame. A reference keyframe left
        behind still holds a few matches far ahead, and the local map
        gathered from them loses the camera within ~2 m; votes of the
        coarse stage's matches, which are the reference keyframe's own,
        keep it as long as it matches at all, and the pose jumps where the
        motion model then takes over."""
        if self.localization_only and res.accept and res.local_ref >= 0:
            return res.local_ref
        return res.next_ref_kf

    def _frozen_kf_Tcw(self) -> np.ndarray:
        """The keyframe poses of the frozen map on the host: copied when
        localization mode starts, and again only if the map is replaced
        (no keyframe moves while the mode lasts)."""
        if self._frozen_poses[0] != self._map_epoch:
            self._frozen_poses = (self._map_epoch, self.map.kf_Tcw.cpu().numpy().copy())
        return self._frozen_poses[1]

    def _turbo_resolve(self, rec: _TurboRec) -> Optional[str]:
        """Host bookkeeping for a dispatched frame. First the loop closer
        advances one step and the global BA one slice (either may move the
        map: this frame was computed before, so it logs against the
        reference pose it was computed with); then the pose, and on a
        keyframe the mapper's outputs, the loop detection's dispatch and a
        deferred local BA. Returns "lost", "loop" (the map moved) or None."""
        with profiling.span("session.resolve", frame_id=int(rec.frame.frame_id)):
            t = self.tracker
            res, frame = rec.res, rec.frame
            pre_ref_pose = t._ref_pose_np
            event = False
            lc = self.loop_closer
            if self.enable_loop_closing and lc is not None and lc.has_pending:
                event = self._finalize_loop_detection()
            if self._step_async_gba():
                event = True
            Tcw_np = res.pose
            n_inl = res.n_inliers
            if not res.accept:
                if self.localization_only and res.ok:
                    # the frozen map no longer holds the frame, but coarse
                    # tracking does: visual odometry takes over, not LOST
                    t.mb_vo = True
                    profiling.count("localization.vo")
                    t.state = TrackState.OK
                    t.velocity = res.next_velocity
                    t.last_inliers = n_inl
                    t._log_pose(frame, True, Tcw_np)
                    self.results.append(TrackResult(Tcw_np, t.state, n_inl, False))
                    self.log.emit("frame", frame_id=int(frame.frame_id), t=float(frame.timestamp),
                                  state="VO", n_inliers=n_inl, is_kf=False)
                    return "loop" if event else None
                t.state = TrackState.LOST
                profiling.count("frame.lost")
                t.velocity = None
                # relocalization must match against the last good frame
                t.last_frame, t.last_point_idx, t.last_Tcw = rec.prev_anchors
                self._anchor = None
                t._log_pose(frame, False)
                self.results.append(TrackResult(Tcw_np, t.state, n_inl, False))
                self.log.emit("frame", frame_id=int(frame.frame_id), t=float(frame.timestamp),
                              state="LOST", n_inliers=n_inl, is_kf=False, ref_kf=int(t.ref_kf))
                # auto-reset while the map is young (ORB-SLAM2 Tracking.cc:502-510),
                # never of a frozen map; the frames still in flight stay queued
                # for the caller to reprocess
                if t.n_keyframes <= 5 and not self.localization_only:
                    self._reset()
                return "lost"
            t.state = TrackState.OK
            # the motion model survives keyframes (ORB-SLAM2 updates it every frame)
            t.velocity = res.next_velocity
            ref_kf = self._next_ref_kf(res)
            if self.localization_only and 0 <= ref_kf != t.ref_kf:
                t.ref_kf, t._ref_pose_np = ref_kf, self._frozen_kf_Tcw()[ref_kf]
            info = dict(frame_id=int(frame.frame_id), t=float(frame.timestamp), state="OK",
                        n_inliers=n_inl, is_kf=res.is_kf)
            if res.is_kf:
                kf_id = res.kf_id
                with profiling.span("mapping.after_keyframe"):
                    with profiling.span("mapping.outputs_read"):
                        kf_Tcw_np, keep, new_pids, cull_ids, cull_red = rec.keyframe_outputs()
                    self.local_mapper.after_keyframe(
                        self.map, kf_id, new_pids, keep, cull_ids, cull_red, rec.window_ids
                    )
                    self._drain_culls()
                if self.enable_loop_closing:
                    event = self._dispatch_loop_detection(kf_id) or event
                self._dispatch_deferred_ba(kf_id)
                # the dispatch-epoch pose, consistent with Tcw_np
                t.on_new_keyframe(kf_id, ref_pose_np=kf_Tcw_np)
                t.frames_since_kf = 0
                info["kf_id"] = kf_id
                self.log.emit("keyframe", kf_id=kf_id, frame_id=int(frame.frame_id),
                              n_new_points=int((new_pids >= 0).sum()))
            else:
                t.frames_since_kf += 1
            t.last_inliers = n_inl
            if event and not res.is_kf:
                # a correction refreshed the reference pose, but this frame's
                # pose predates it
                corrected = t._ref_pose_np
                t._ref_pose_np = pre_ref_pose
                t._log_pose(frame, True, Tcw_np)
                t._ref_pose_np = corrected
            else:
                t._log_pose(frame, True, Tcw_np)
            self.results.append(TrackResult(Tcw_np, t.state, n_inl, res.is_kf))
            self.log.emit("frame", **info)
            return "loop" if event else None

    def _reprocess(self, rec: _TurboRec):
        a, b, timestamp = rec.inputs
        if self.tracker.state == TrackState.OK:
            return self._track_turbo(a, b, timestamp)
        return self._track(self._build_frame(a, b, timestamp))

    def _reprocess_stale(self, extra: Optional[_TurboRec] = None):
        """Reprocess, in dispatch order, every frame still in flight after
        a lost one (they chained off its pose), and `extra`. A keyframe
        that such a dispatch already inserted is first folded into the
        host bookkeeping, logged as orphaned, unless the map was replaced
        since (an auto-reset: the insert went with the old map)."""
        stale = self._pending + ([extra] if extra is not None else [])
        self._pending = []
        for s in stale:
            if (s.epoch != self._map_epoch or not s.res.is_kf
                    or not (self.enable_mapping and not self.localization_only)):
                continue
            kf_id = s.res.kf_id
            _, keep, new_pids, cull_ids, cull_red = s.keyframe_outputs()
            self.local_mapper.after_keyframe(self.map, kf_id, new_pids, keep, cull_ids, cull_red,
                                             s.window_ids)
            self._drain_culls()
            if self.loop_closer is not None:
                self.loop_closer.add_keyframe_to_db(self.map, kf_id)
            self._dispatch_deferred_ba(kf_id)
            t = self.tracker
            t.n_keyframes += 1
            t.new_keyframe_ids.append(kf_id)
            self.log.emit("keyframe", kf_id=kf_id, frame_id=int(s.frame.frame_id), orphaned=True,
                          n_new_points=int((new_pids >= 0).sum()))
        out = None
        for s in stale:
            out = self._reprocess(s)
        return out

    def _absorb_pending(self, extra: Optional[_TurboRec] = None):
        """After a resolve that moved the map (a loop correction or a
        global-BA fold-in): resolve the frames still in flight, and
        `extra`. Their dispatches saw the map before the move, and each
        logs against the reference pose it was dispatched with. Then carry
        the newest frame's pose into the moved map through its pose
        relative to the reference keyframe (ORB-SLAM2 re-derives the frame
        pose from the updated reference the same way); the motion model is
        relative and stays. A frame lost among them hands the rest to
        `_reprocess_stale`."""
        pending = self._pending + ([extra] if extra is not None else [])
        self._pending = []
        while pending:
            if self._turbo_resolve(pending.pop(0)) == "lost":
                self._pending = pending
                self._anchor = None
                self._reprocess_stale()
                return
        t = self.tracker
        if t.state == TrackState.OK and t.trajectory:
            _, Tcr, ref, okf = t.trajectory[-1]
            t.refresh_ref_pose()
            if ref >= 0 and ref == t.ref_kf and okf:
                t.last_Tcw = self._pose_tensor(Tcr @ t._ref_pose_np)
        self._anchor = None

    def _pose_tensor(self, T: np.ndarray) -> torch.Tensor:
        return torch.tensor(T, dtype=torch.float32, device=self.device)

    def _drain_culls(self):
        """Re-anchor trajectory entries that reference keyframes the mapper
        just culled, to the culled keyframe's spanning-tree parent."""
        for c, parent, Tcp in self.local_mapper.culled_log:
            self.tracker.remap_trajectory_ref(c, parent, Tcp)
        self.local_mapper.culled_log.clear()

    # -- loop closing --------------------------------------------------------

    def _vocab_path(self) -> Optional[str]:
        """The vocabulary file `cfg.vocab.vocab_file` names ("builtin": the
        package's `data/vocab.npz`), or None when there is none."""
        path = self.cfg.vocab.vocab_file
        if not path:
            return None
        if path == "builtin":
            path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "data", "vocab.npz")
        return path if os.path.exists(path) else None

    def _load_vocab_file(self):
        """The vocabulary file and its per-word idf weights: (codebook,
        idf), or (None, None) without a file."""
        path = self._vocab_path()
        if path is None:
            return None, None
        with np.load(path) as z:
            return self._codebook_from(z, "coarse", "fine", "codebook")

    def _codebook_from(self, z, coarse: str, fine: str, flat: str):
        idf = convert.to_tensor(z["idf"], self.device) if "idf" in z.files else None
        if coarse in z.files:
            return bow.Codebook(coarse=convert.to_tensor(z[coarse], self.device),
                                fine=convert.to_tensor(z[fine], self.device)), idf
        return convert.to_tensor(z[flat], self.device), idf

    def _ensure_loop_closer(self, kf_id: int):
        """Make the loop closer with the vocabulary file's codebook (frozen),
        or without a file with 256 words trained on this keyframe's
        descriptors, which the loop closer then retrains as the session
        grows (its draws from a CPU generator seeded `cfg.vocab.seed`).
        With `cfg.vocab.warmup_correction` the correction chain then runs
        once on a throwaway map, off the frames that verify or correct, and
        with `cfg.vocab.warmup_reloc` the relocalization chain, off the
        first relocalizing frame."""
        if self.loop_closer is not None:
            return
        with profiling.span("loop.create"):
            codebook, idf = self._load_vocab_file()
            frozen = codebook is not None
            if codebook is None:
                vc = self.cfg.vocab
                valid = self.map.kf_feat_valid[kf_id]
                size = min(256, vc.vocab_size)
                seeds = bow.draw_codebook_seeds(valid, size, vc.train_iters,
                                                torch.Generator().manual_seed(vc.seed))
                codebook = bow.train_codebook(self.map.kf_desc[kf_id], valid, seeds, size,
                                              vc.train_iters)
            self.loop_closer = LoopCloser(self.cfg, self.builder.K, codebook, self.device,
                                          log=self.log, frozen_vocab=frozen, idf=idf)
            if self.cfg.vocab.warmup_correction:
                self.loop_closer.warmup_correction(self.map)
            if self.cfg.vocab.warmup_reloc:
                self.tracker.warmup_reloc(self.loop_closer.db)

    def _dispatch_loop_detection(self, kf_id: int) -> bool:
        """Register the keyframe with the database and dispatch its
        detection; returns True if finalising a still-pending detection
        first fired a correction."""
        self._ensure_loop_closer(kf_id)
        lc = self.loop_closer
        event = False
        if lc._pending_detect is not None:
            # finalise only the detection; a verification in flight is
            # polled on later frames
            event = self._finalize_loop_detection(detect_only=True)
        lc.add_keyframe_to_db(self.map, kf_id)
        lc.dispatch_detect(self.map, kf_id)
        return event

    def _finalize_loop_detection(self, detect_only: bool = False) -> bool:
        """Advance the loop closer by one step (a pending detection or
        verification). Returns True when a loop correction moved the map."""
        lc = self.loop_closer
        if detect_only:
            _, result = lc.finalize_detect(self.map)
        else:
            _, result = lc.process_async(self.map)
        if result is not None and result.detected:
            self.log.emit("loop_closed", matched_kf=int(result.matched_kf),
                          num_inliers=int(result.num_inliers), loops_closed=lc.loops_closed,
                          obs_truncations=lc.obs_truncations,
                          edge_truncations=lc.edge_truncations)
            self._reanchor_after_map_move()
            return True
        return False

    def _reanchor_after_map_move(self):
        """Re-anchor tracking after a global map move (a loop correction or
        a global-BA fold-in): refresh the reference keyframe's pose and
        carry the last frame's pose into the moved map through its pose
        relative to that keyframe. The motion model is relative and
        stays."""
        t = self.tracker
        t.refresh_ref_pose()
        last = t.trajectory[-1] if t.trajectory else None
        if last is not None and last[2] >= 0 and last[2] == t.ref_kf and last[3]:
            t.last_Tcw = self._pose_tensor(last[1] @ t._ref_pose_np)
        elif t.ref_kf >= 0:
            t.last_Tcw = self.map.kf_Tcw[t.ref_kf].clone()
        self._anchor = None

    def _dispatch_deferred_ba(self, kf_id: int):
        """With `cfg.tracking.defer_local_ba`, the local BA the keyframe's
        step skipped, run at its resolve: later dispatches see its result
        on the card, and the host never reads it."""
        if (not self.cfg.tracking.defer_local_ba or self.localization_only
                or not self.enable_mapping):
            return
        kw = self._kf_kwargs()
        fused.deferred_local_ba(
            self.map, kf_id, self.local_mapper.inv_sigma2, self.tracker.K,
            **{k: kw[k] for k in ("max_local", "max_fixed", "max_points", "obs_slots", "iters1",
                                  "iters2")},
        )

    def _step_async_gba(self) -> bool:
        """Run one slice of a global BA in flight. Returns True when it
        finished and was folded into the map (tracking re-anchors as after
        a loop correction)."""
        lc = self.loop_closer
        if lc is None or lc._gba is None:
            return False
        _, folded = lc.step_gba_async(self.map)
        if not folded:
            return False
        self._reanchor_after_map_move()
        return True

    def flush(self):
        """Resolve every frame in flight, oldest first (a loop correction
        among them absorbs the rest, a lost one reprocesses them), then
        drain the loop closer: every pending detection and queued
        verification, then any global BA in flight to its end. Every
        introspection and export entry calls it, as in the reference."""
        while self._pending:
            ev = self._turbo_resolve(self._pending.pop(0))
            if ev == "loop":
                self._absorb_pending()
            elif ev == "lost":
                self._anchor = None
                self._reprocess_stale()
        while self.loop_closer is not None and self.loop_closer.has_pending:
            self._finalize_loop_detection()
        while self.loop_closer is not None and self.loop_closer._gba is not None:
            self._step_async_gba()
        self._anchor = None

    # -- frames outside steady state -------------------------------------------

    @profiling.spanned("tracking.slow")
    def _track(self, frame: FrameData) -> np.ndarray:
        """Frames outside steady state (initialization, LOST)."""
        self.flush()
        prior_state = self.tracker.state
        reloc_db = self.loop_closer.db if self.loop_closer is not None else None
        res = self.tracker.process(frame, reloc_db=reloc_db)
        self._drain_culls()
        n_kf_ev = self.log.counts().get("keyframe", 0)
        self._handle_kf_request()
        self._step_async_gba()
        self.results.append(res)
        if res.is_keyframe and self.log.counts().get("keyframe", 0) == n_kf_ev:
            # keyframe created inside tracker.process (initialization)
            self.log.emit("keyframe", kf_id=self.tracker.ref_kf,
                          frame_id=int(frame.frame_id), n_new_points=-1)
        if prior_state == TrackState.LOST and res.state == TrackState.OK:
            self.log.emit("relocalized", frame_id=int(frame.frame_id),
                          n_inliers=int(res.num_inliers))
        if res.state == TrackState.LOST:
            profiling.count("frame.lost")
        self.log.emit("frame", frame_id=int(frame.frame_id), t=float(frame.timestamp),
                      state=res.state.name, n_inliers=int(res.num_inliers),
                      is_kf=bool(res.is_keyframe))
        if (res.state == TrackState.LOST and self.tracker.n_keyframes <= 5
                and not self.localization_only):
            self.reset()
        return res.Tcw

    def _handle_kf_request(self):
        """Run the keyframe pipeline for a keyframe the synchronous tracker
        requested, then refresh the tracker's anchors: BA may have moved
        the keyframe, so the motion model is dropped."""
        request, self.tracker.kf_request = self.tracker.kf_request, None
        if request is None or not self.enable_mapping or self.localization_only:
            return
        kf_frame, kf_Tcw, kf_bind = request
        kf_id, kf_Tcw_new, kf_bind_new, kf_Tcw_np, loop_fired = self._run_keyframe_pipeline(
            kf_frame, kf_Tcw, kf_bind
        )
        self.tracker.on_new_keyframe(kf_id, ref_pose_np=None if loop_fired else kf_Tcw_np)
        self.tracker.last_Tcw = kf_Tcw_new
        self.tracker.last_point_idx = kf_bind_new
        self.tracker.velocity = None

    def _run_keyframe_pipeline(self, frame: FrameData, Tcw, point_idx):
        """`fused.keyframe_full_step` for one keyframe, then the mapper's
        host bookkeeping and, with loop closing, the synchronous loop
        closing of this keyframe. Returns (kf_id, post-BA pose, post-BA
        bindings, the pose on the host, whether a loop closed)."""
        t = self.tracker
        mapper = self.local_mapper
        window = mapper.probation_window()
        kf_id, new_pids, keep, kf_Tcw_new, kf_bind_new, cull_ids, cull_red = (
            fused.keyframe_full_step(
                self.map, frame, Tcw, point_idx, window,
                self.builder.K, t._params, mapper.level_sigma2, mapper.inv_sigma2,
                run_ba=t.n_keyframes >= 2,  # this insert makes the third keyframe
                **self._kf_kwargs(),
            )
        )
        kf_Tcw_np, keep, new_pids, cull_ids, cull_red = (
            x.cpu().numpy() for x in (kf_Tcw_new, keep, new_pids, cull_ids, cull_red)
        )
        mapper.after_keyframe(self.map, kf_id, new_pids, keep, cull_ids, cull_red, window)
        self._drain_culls()
        self.log.emit("keyframe", kf_id=kf_id, frame_id=int(frame.frame_id),
                      n_new_points=int((new_pids >= 0).sum()))
        loop_fired = False
        if self.enable_loop_closing:
            n_before = self.loop_closer.loops_closed if self.loop_closer is not None else 0
            self._run_loop_closing(kf_id)
            loop_fired = self.loop_closer.loops_closed > n_before
        return kf_id, kf_Tcw_new, kf_bind_new, kf_Tcw_np, loop_fired

    def _run_loop_closing(self, kf_id: int):
        """Synchronous detection and correction for this keyframe, after
        draining what the steady-state path left in flight."""
        self._ensure_loop_closer(kf_id)
        lc = self.loop_closer
        while lc.has_pending:
            self._finalize_loop_detection()
        _, result = lc.process_keyframe(self.map, kf_id)
        if result is not None and result.detected:
            self.log.emit("loop_closed", matched_kf=int(result.matched_kf),
                          num_inliers=int(result.num_inliers), loops_closed=lc.loops_closed,
                          obs_truncations=lc.obs_truncations,
                          edge_truncations=lc.edge_truncations)
            self.tracker.refresh_ref_pose()

    def change_calibration(self, camera_cfg):
        """Swap the camera intrinsics (ORB-SLAM2 Tracking::ChangeCalibration).
        The map is kept; the frame builder and the tracker are made anew for
        the new camera, with the tracker's session state carried over, as in
        the reference (which carries neither its RANSAC key nor mbVO)."""
        self.flush()
        self.cfg = dataclasses.replace(self.cfg, camera=camera_cfg)
        old = self.tracker
        self.builder = FrameBuilder(self.cfg, self.device)
        self.tracker = Tracker(self.cfg, self.builder, self.map)
        for attr in ("state", "velocity", "last_Tcw", "last_frame", "last_point_idx", "ref_kf",
                     "frames_since_kf", "n_keyframes", "trajectory", "new_keyframe_ids",
                     "_ref_pose_np", "last_inliers"):
            setattr(self.tracker, attr, getattr(old, attr))
        self.local_mapper.K = self.builder.K

    def activate_localization_mode(self):
        """Freeze the map: tracking only, no keyframes, no auto-reset."""
        self.flush()
        self.localization_only = True
        self._frozen_poses = (None, None)
        self._frozen_kf_Tcw()

    def deactivate_localization_mode(self):
        self.flush()
        self.localization_only = False

    def shutdown(self):
        """Finish the session's pending work (the loop closer's queue and
        any global BA in flight), as the reference's Shutdown waits for its
        threads."""
        self.flush()

    def reset(self):
        """Clear the map and return to NOT_INITIALIZED; the trajectory log
        survives."""
        self.flush()
        self._reset()

    def _reset(self):
        """`reset` without draining first (an auto-reset from a frame's
        resolve, as in the reference): the frames still in flight stay
        queued for the caller to reprocess on the new map."""
        self.log.emit("reset", n_keyframes=self.tracker.n_keyframes)
        self._anchor = None
        self._map_epoch += 1
        old_traj = self.tracker.trajectory
        self.map = ms.allocate(self.cfg.map, self.cfg.orb, self.device)
        self.tracker = Tracker(self.cfg, self.builder, self.map)
        self.tracker.trajectory = old_traj
        self.local_mapper = LocalMapper(self.cfg, self.builder.K, self.tracker.bounds, self.device)
        self.loop_closer = None

    # -- introspection -----------------------------------------------------

    def get_tracking_state(self) -> TrackState:
        self.flush()
        return self.tracker.state

    def num_keyframes(self) -> int:
        self.flush()
        return int(torch.sum(self.map.kf_valid))

    def num_points(self) -> int:
        self.flush()
        return int(torch.sum(self.map.mp_valid))

    def get_tracked_map_points(self) -> np.ndarray:
        """Per feature slot of the current frame, the bound map point's id,
        -1 where unbound (ORB-SLAM2 System::GetTrackedMapPoints)."""
        self.flush()
        if self.tracker.last_point_idx is None:
            return np.full((self.cfg.orb.feature_slots,), -1, np.int32)
        return self.tracker.last_point_idx.cpu().numpy()

    def get_tracked_keypoints_un(self) -> tuple[np.ndarray, np.ndarray]:
        """(xy [S, 2] undistorted keypoints of the current frame, valid [S])
        (ORB-SLAM2 System::GetTrackedKeyPointsUn)."""
        self.flush()
        lf = self.tracker.last_frame
        if lf is None:
            S = self.cfg.orb.feature_slots
            return np.zeros((S, 2), np.float32), np.zeros((S,), bool)
        return lf.xy.cpu().numpy(), lf.valid.cpu().numpy()

    def frame_poses(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(timestamps [N], poses_cw [N,4,4], tracked [N]) with each frame's
        pose re-anchored to its reference keyframe's final pose."""
        self.flush()
        kf_poses = self.map.kf_Tcw.cpu().numpy()
        ts, poses, tracked = [], [], []
        for t, Tcr, ref, ok in self.tracker.trajectory:
            ts.append(t)
            poses.append(Tcr @ kf_poses[ref] if ref >= 0 else Tcr)
            tracked.append(ok)
        return np.asarray(ts), np.stack(poses), np.asarray(tracked)

    # -- export ------------------------------------------------------------

    def save_trajectory_tum(self, path: str):
        ts, poses, tracked = self.frame_poses()
        traj_io.save_tum(path, ts[tracked], poses[tracked])

    def save_keyframe_trajectory_tum(self, path: str):
        """The live keyframes' poses, stamped with their source frame ids."""
        valid = self.map.kf_valid.cpu().numpy()
        poses = self.map.kf_Tcw.cpu().numpy()[valid]
        fids = self.map.kf_frame_id.cpu().numpy()[valid]
        traj_io.save_tum(path, fids.astype(np.float64), poses)

    def save_trajectory_kitti(self, path: str):
        """Every frame's pose, in KITTI's 3x4 Twc rows."""
        _, poses, _ = self.frame_poses()
        traj_io.save_kitti(path, poses)

    # -- map persistence ---------------------------------------------------

    def save_map(self, path: str):
        """Write the map to an `.npz` in the reference's layout: one
        `map_<field>` array per field, descriptors as uint32, and with a
        loop closer its BoW database, codebook and idf weights."""
        self.flush()
        payload = {f"map_{k}": v for k, v in convert.map_state_to_numpy(self.map).items()}
        lc = self.loop_closer
        if lc is not None:
            payload["db_vectors"] = convert.to_numpy(lc.db.vectors)
            payload["db_present"] = convert.to_numpy(lc.db.present)
            if isinstance(lc.codebook, bow.Codebook):
                payload["codebook_coarse"] = convert.to_numpy(lc.codebook.coarse, descriptor=True)
                payload["codebook_fine"] = convert.to_numpy(lc.codebook.fine, descriptor=True)
            else:
                payload["codebook"] = convert.to_numpy(lc.codebook, descriptor=True)
            if lc.idf is not None:
                payload["idf"] = convert.to_numpy(lc.idf)
        np.savez_compressed(path, **payload)

    def load_map(self, path: str):
        """Replace the map with one saved by either package's `save_map`;
        a BoW database in the file comes with it (a frozen vocabulary, as
        in the reference)."""
        self.flush()
        self._map_epoch += 1
        with np.load(path) as z:
            fields = {k[4:]: z[k] for k in z.files if k.startswith("map_")}
            has_codebook = "codebook" in z.files or "codebook_coarse" in z.files
            if "db_vectors" in z.files and not has_codebook:
                raise ValueError(f"{path}: a BoW database without its codebook")
            if has_codebook:
                codebook, idf = self._codebook_from(z, "codebook_coarse", "codebook_fine",
                                                    "codebook")
                self.loop_closer = LoopCloser(self.cfg, self.builder.K, codebook, self.device,
                                              log=self.log, frozen_vocab=True, idf=idf)
                self.loop_closer.db.vectors = convert.to_tensor(z["db_vectors"], self.device)
                self.loop_closer.db.present = convert.to_tensor(z["db_present"], self.device)
        self.map = convert.map_state_from_numpy(fields, self.device)
        self.tracker.map = self.map
        self.tracker.n_keyframes = self.num_keyframes()
        self.local_mapper.live_kfs = self.tracker.n_keyframes
