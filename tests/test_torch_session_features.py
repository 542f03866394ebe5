"""Session features of the port against the reference on the same frames:
localization mode with the mbVO dual hypothesis, the relocalization
warm-up, calibration change, the tracked-points queries, shutdown, and
the ports of `tests/test_system_features.py` (its session tests marked
slow, as there).

Tolerances: per-frame poses within 5 mm and 0.2 degrees on the frames
both packages track; the per-frame mbVO flags, tracking states and
keyframe counts exactly equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_tpu.io import synthetic
from orbslam2_tpu.pipeline.system import System as JSystem
from orbslam2_tpu.pipeline.tracking import TrackState as JTrackState
from orbslam2_tpu_torch import trajectory as ttraj
from orbslam2_tpu_torch.config import SlamConfig as TSlamConfig
from orbslam2_tpu_torch.pipeline.system import System as TSystem
from orbslam2_tpu_torch.pipeline.tracking import TrackState
from tests.test_e2e_rgbd import small_cfg
from tests.torch_config import port_config
from tests.torch_threads import share_cores

share_cores()

DT_M, DEG = 5e-3, 0.2
LOC_MAP_FRAMES = 10
# degrees of yaw from the last mapped pose: away from the mapped view in
# even steps (the motion model stays right, so the map's matches thin out
# until tracking still holds coarsely but under the local-map gate, and the
# odometry takes over and tracks), then back until relocalization
# re-anchors
LOC_YAWS = list(range(5, 75, 5)) + [60, 50, 40]


def yawed(seq, base, yaws):
    """`seq` rendered at `base` turned about the camera's y axis by each
    of `yaws` degrees."""
    poses = []
    for yaw in yaws:
        a = np.radians(yaw)
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses.append(T @ base)
    return dataclasses.replace(seq, poses=np.stack(poses))


def pose_gaps(pa, pb):
    """Per-frame translation (m) and rotation (deg), each rotation first
    projected onto SO(3) in float64: the tracked float32 poses drift off
    it in the odometry's frames, and a float32 arccos of the trace reads
    that drift as rotation."""
    def so3(R):
        U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
        return U @ Vt

    dt = np.linalg.norm(np.asarray(pa[:, :3, 3], np.float64) - pb[:, :3, 3], axis=1)
    R = np.einsum("nji,njk->nik", so3(pa[:, :3, :3]), so3(pb[:, :3, :3]))
    deg = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    return dt, deg


def localization_session(slam, seq, rot):
    """Map `seq`, enter localization mode, track `rot`. Returns the
    keyframes before and after, and per localization frame the mbVO flag,
    the state and the pose."""
    for i in range(len(seq)):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    n_kf = slam.num_keyframes()
    slam.activate_localization_mode()
    flags, states, poses = [], [], []
    for j in range(len(rot)):
        img, depth = rot.frame(j)
        slam.track_rgbd(img, depth, timestamp=(len(seq) + j) / 30.0)
        flags.append(bool(slam.tracker.mb_vo))
        states.append(slam.results[-1].state.name)
        poses.append(slam.results[-1].Tcw)
    return dict(n_kf=n_kf, n_kf_after=slam.num_keyframes(), flags=flags, states=states,
                poses=np.stack(poses))


@pytest.fixture(scope="module")
def loc_sessions():
    cfg = small_cfg()
    seq = synthetic.textured_sequence(n_frames=LOC_MAP_FRAMES, kind="forward", cam=cfg.camera)
    rot = yawed(seq, seq.poses[-1], LOC_YAWS)
    ref = JSystem(cfg)
    port = TSystem(port_config(cfg), device="cpu")
    return (rot, ref, localization_session(ref, seq, rot),
            port, localization_session(port, seq, rot))


def test_localization_session_matches_reference(loc_sessions):
    """Localization mode on a mapped session, turned away from the map and
    back: the reference's mbVO flags and states per frame, no keyframe
    made, the odometry engaged and handed back to relocalization, and the
    poses of the frames both track within 5 mm and 0.2 degrees."""
    rot, ref, r, port, p = loc_sessions
    assert p["flags"] == r["flags"], (p["flags"], r["flags"])
    assert p["states"] == r["states"], (p["states"], r["states"])
    assert p["n_kf_after"] == p["n_kf"] == r["n_kf"] == r["n_kf_after"]
    assert any(p["flags"]) and not p["flags"][-1]
    assert "VO" in [e["state"] for e in port.log.of("frame")]
    ok = np.asarray(p["states"]) == "OK"
    dt, deg = pose_gaps(p["poses"][ok], r["poses"][ok])
    assert dt.max() < DT_M and deg.max() < DEG, (dt.max(), deg.max())
    err = np.linalg.norm((p["poses"][-1] @ np.linalg.inv(rot.poses[-1]))[:3, 3])
    assert err < 0.05, err


def test_tracked_points_and_keypoints_match_reference(loc_sessions):
    """After the session: the current frame's undistorted keypoints equal
    the reference's to 1e-3 px, and its bound slots agree on 98 % of the
    slots; `shutdown` drains and keeps the state."""
    _, ref, _, port, _ = loc_sessions
    xy_t, valid_t = port.get_tracked_keypoints_un()
    xy_j, valid_j = ref.get_tracked_keypoints_un()
    np.testing.assert_array_equal(valid_t, valid_j)
    np.testing.assert_allclose(xy_t[valid_t], xy_j[valid_j], atol=1e-3)
    mp_t, mp_j = port.get_tracked_map_points(), ref.get_tracked_map_points()
    assert mp_t.shape == mp_j.shape == (port.cfg.orb.feature_slots,)
    assert np.mean((mp_t >= 0) == (mp_j >= 0)) >= 0.98
    np.testing.assert_array_equal(mp_t, port.tracker.last_point_idx.numpy())
    port.shutdown()
    assert port.get_tracking_state() == TrackState.OK


def test_relocalization_warmup_leaves_no_trace():
    """Two sessions, `warmup_reloc` on and off, relocalizing after a
    blackout at the tests' 320x240 configuration (in localization mode,
    so that losing a two-keyframe map does not reset it): the same poses,
    the same state of the tracker's generator and the same map tensors."""
    from tests.test_torch_mapping_slice import CFG

    cfg = port_config(CFG)
    seq = synthetic.textured_sequence(n_frames=12, kind="forward", cam=CFG.camera)
    black = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    out = []
    for warm in (False, True):
        c = dataclasses.replace(cfg, vocab=dataclasses.replace(cfg.vocab, warmup_reloc=warm))
        slam = TSystem(c, device="cpu")
        calls = []
        slam.tracker.warmup_reloc = lambda db, f=slam.tracker.warmup_reloc: (calls.append(1), f(db))
        for i in range(12):
            img, depth = seq.frame(i)
            slam.track_rgbd(img, depth, timestamp=i / 30.0)
        assert calls == ([1] if warm else [])
        slam.activate_localization_mode()
        slam.track_rgbd(black, black, timestamp=12 / 30.0)
        img, depth = seq.frame(4)
        slam.track_rgbd(img, depth, timestamp=13 / 30.0)
        out.append(slam)
    off, on = out
    assert [r.state for r in on.results] == [r.state for r in off.results]
    assert on.results[-2].state == TrackState.LOST and on.results[-1].state == TrackState.OK
    np.testing.assert_array_equal(np.stack([r.Tcw for r in on.results]),
                                  np.stack([r.Tcw for r in off.results]))
    assert torch.equal(on.tracker.init_generator.get_state(), off.tracker.init_generator.get_state())
    for f in dataclasses.fields(on.map):
        assert torch.equal(getattr(on.map, f.name), getattr(off.map, f.name)), f.name


def test_change_calibration_rebuilds_the_camera():
    """`change_calibration` swaps the intrinsics of the session's frame
    builder, tracker and mapper, as the reference's does."""
    cfg = port_config(small_cfg())
    slam = TSystem(cfg, device="cpu")
    ref = JSystem(small_cfg())
    new_cam = dataclasses.replace(cfg.camera, fx=481.0, fy=482.0)
    slam.change_calibration(new_cam)
    ref.change_calibration(dataclasses.replace(small_cfg().camera, fx=481.0, fy=482.0))
    assert slam.cfg.camera == new_cam
    for k in ("fx", "fy", "cx", "cy"):
        assert float(getattr(slam.builder.K, k)) == float(getattr(ref.builder.K, k))
    assert slam.tracker.K is slam.builder.K and slam.local_mapper.K is slam.builder.K
    assert slam.tracker.state == TrackState.NOT_INITIALIZED


def test_culled_ref_trajectory_reanchor():
    """`tests/test_system_features.py::test_culled_ref_trajectory_reanchor`
    on the port, with the reference's tracker on the same log: frames
    logged against a culled keyframe re-anchor to its parent."""
    from orbslam2_tpu.config import SlamConfig as JSlamConfig
    from orbslam2_tpu.pipeline.frame import FrameBuilder as JFrameBuilder
    from orbslam2_tpu.pipeline.tracking import Tracker as JTracker
    from orbslam2_tpu.slam_map import map_state as jms
    from orbslam2_tpu_torch.pipeline.frame import FrameBuilder
    from orbslam2_tpu_torch.pipeline.tracking import Tracker
    from orbslam2_tpu_torch.slam_map import map_state as ms

    cfg = TSlamConfig()
    t = Tracker(cfg, FrameBuilder(cfg, "cpu"), ms.allocate(cfg.map, cfg.orb, "cpu"))
    jcfg = JSlamConfig()
    j = JTracker(jcfg, JFrameBuilder(jcfg), jms.allocate(jcfg.map, jcfg.orb))
    Tcr = np.eye(4)
    Tcr[0, 3] = 1.0
    Tcp = np.eye(4)
    Tcp[2, 3] = 3.0
    for tr in (t, j):
        tr.trajectory = [(0.0, Tcr.copy(), 5, True), (1.0, np.eye(4), 2, True)]
        tr.remap_trajectory_ref(5, 2, Tcp)
    assert [(a, r, ok) for a, _, r, ok in t.trajectory] == [(0.0, 2, True), (1.0, 2, True)]
    for (_, Tt, _, _), (_, Tj, _, _) in zip(t.trajectory, j.trajectory):
        np.testing.assert_array_equal(Tt, Tj)
    np.testing.assert_allclose(t.trajectory[0][1], Tcr @ Tcp)
    Tparent = np.eye(4)
    Tparent[1, 3] = -2.0
    np.testing.assert_allclose(t.trajectory[0][1] @ Tparent, Tcr @ Tcp @ Tparent)


# -- the slow session tests of tests/test_system_features.py -------------


@pytest.fixture(scope="module")
def mapped_session():
    cfg = small_cfg()
    seq = synthetic.textured_sequence(n_frames=14, kind="forward", cam=cfg.camera)
    slam = TSystem(port_config(cfg), device="cpu")
    for i in range(len(seq)):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    assert slam.get_tracking_state() == TrackState.OK
    return cfg, seq, slam


@pytest.mark.slow
class TestSystemFeatures:
    def test_localization_mode_no_new_keyframes(self, mapped_session):
        cfg, seq, slam = mapped_session
        n_kf = slam.num_keyframes()
        slam.activate_localization_mode()
        for i in range(8, 14):
            img, depth = seq.frame(i)
            slam.track_rgbd(img, depth, timestamp=(14 + i) / 30.0)
        assert slam.get_tracking_state() == TrackState.OK
        assert slam.num_keyframes() == n_kf
        slam.deactivate_localization_mode()

    def test_save_load_map_roundtrip(self, mapped_session, tmp_path):
        cfg, seq, slam = mapped_session
        path = str(tmp_path / "map.npz")
        slam.save_map(path)
        slam2 = TSystem(port_config(cfg), device="cpu")
        slam2.load_map(path)
        assert slam2.num_keyframes() == slam.num_keyframes()
        assert slam2.num_points() == slam.num_points()
        slam2.activate_localization_mode()
        slam2.tracker.state = TrackState.LOST
        img, depth = seq.frame(10)
        recovered = False
        for j in range(2):
            slam2.track_rgbd(img, depth, timestamp=j / 30.0)
            if slam2.get_tracking_state() == TrackState.OK:
                recovered = True
                break
        assert recovered
        e = slam2.results[-1].Tcw @ np.linalg.inv(seq.poses[10])
        assert np.linalg.norm(e[:3, 3]) < 0.1

    def test_event_log_stream(self, mapped_session, tmp_path):
        import json

        cfg, seq, slam = mapped_session
        slam.flush()
        counts = slam.log.counts()
        assert counts["frame"] == len(slam.results)
        frames = slam.log.of("frame")
        for e in frames:
            assert {"frame_id", "t", "state", "n_inliers", "is_kf"} <= set(e)
        n_kf_frames = sum(1 for e in frames if e["is_kf"])
        assert counts.get("keyframe", 0) == n_kf_frames >= 1
        ok_inliers = [e["n_inliers"] for e in frames if e["state"] == "OK"]
        assert len(ok_inliers) > 1 and min(ok_inliers[1:]) > 0
        path = str(tmp_path / "events.jsonl")
        slam.log.save(path)
        with open(path) as fh:
            lines = [json.loads(line) for line in fh]
        assert lines == slam.log.events

    def test_trajectory_export(self, mapped_session, tmp_path):
        cfg, seq, slam = mapped_session
        p_tum = str(tmp_path / "traj.txt")
        p_kitti = str(tmp_path / "traj_kitti.txt")
        p_kf = str(tmp_path / "kf.txt")
        slam.save_trajectory_tum(p_tum)
        slam.save_trajectory_kitti(p_kitti)
        slam.save_keyframe_trajectory_tum(p_kf)
        ts, poses = ttraj.load_tum(p_tum)
        assert len(ts) >= 14
        kitti_lines = open(p_kitti).read().strip().split("\n")
        assert len(kitti_lines[0].split()) == 12
        ts_kf, poses_kf = ttraj.load_tum(p_kf)
        assert len(ts_kf) == slam.num_keyframes()

    def test_change_calibration(self, mapped_session):
        cfg, seq, slam = mapped_session
        new_cam = dataclasses.replace(slam.cfg.camera, fx=481.0, fy=481.0)
        slam.change_calibration(new_cam)
        assert slam.cfg.camera.fx == 481.0
        img, depth = seq.frame(12)
        slam.track_rgbd(img, depth, timestamp=99.0)
        assert slam.get_tracking_state() == TrackState.OK


@pytest.mark.slow
def test_localization_mbvo_blackout_and_recovery():
    """`test_system_features.py`'s mbVO session on both packages: 22
    mapped frames, localization mode, a turn of 110 degrees away at 2.5
    degrees a frame, 4 frames held, and back. The port engages mbVO on the
    reference's frames, keeps the map frozen and ends relocalized within
    0.15 m of the ground truth, out of mbVO."""
    cfg = small_cfg()
    seq = synthetic.textured_sequence(n_frames=22, kind="forward", cam=cfg.camera)
    yaws = list(np.arange(2.5, 111, 2.5)) + [110.0] * 4 + list(np.arange(107.5, -0.1, -2.5))
    rot = yawed(seq, seq.poses[21], yaws)
    r = localization_session(JSystem(cfg), seq, rot)
    p = localization_session(TSystem(port_config(cfg), device="cpu"), seq, rot)
    assert sum(p["flags"]) > 0 and sum(r["flags"]) > 0
    assert p["n_kf_after"] == p["n_kf"] == r["n_kf"]
    assert p["flags"] == r["flags"]
    err = np.linalg.norm((p["poses"][-1] @ np.linalg.inv(rot.poses[-1]))[:3, 3])
    assert err < 0.15, err
    assert not p["flags"][-1]


@pytest.mark.slow
def test_nondefault_pyramid_tracks():
    """num_levels=6, scale_factor=1.25 end to end on the port, with the
    reference's bar, and the reference's keyframes."""
    from orbslam2_tpu.config import OrbConfig

    from orbslam2_tpu_torch.evaluation import ate_rmse

    cfg = dataclasses.replace(small_cfg(), orb=OrbConfig(
        num_features=600, feature_slots=640, candidates_per_level=2048,
        num_levels=6, scale_factor=1.25))
    seq = synthetic.textured_sequence(n_frames=10, kind="forward", cam=cfg.camera)
    slams = (TSystem(port_config(cfg), device="cpu"), JSystem(cfg))
    for slam in slams:
        for i in range(10):
            img, depth = seq.frame(i)
            slam.track_rgbd(img, depth, timestamp=i / 30.0)
    port, ref = slams
    _, poses, tracked = port.frame_poses()
    assert tracked.all()
    assert ate_rmse(poses, seq.poses, align=True) < 0.03
    assert ([i for i, r in enumerate(port.results) if r.is_keyframe]
            == [i for i, r in enumerate(ref.results) if r.is_keyframe])
    assert ref.get_tracking_state() == JTrackState.OK


@pytest.mark.slow
def test_outback_no_false_loop():
    """`tests/test_loop_reloc.py::test_outback_no_false_loop` on both
    packages: the corridor out and back keeps its covisibility, so no loop
    closes; the port tracks with the reference test's bars and makes the
    reference's keyframes."""
    from orbslam2_tpu_torch.evaluation import ate_rmse

    cfg = small_cfg()
    seq = synthetic.textured_sequence(n_frames=44, kind="outback", cam=cfg.camera)
    port, ref = TSystem(port_config(cfg), device="cpu"), JSystem(cfg)
    for slam in (port, ref):
        for i in range(len(seq)):
            img, depth = seq.frame(i)
            slam.track_rgbd(img, depth, timestamp=i / 30.0)
    assert port.get_tracking_state() == TrackState.OK
    _, poses, tracked = port.frame_poses()
    assert tracked.sum() >= len(seq) - 2
    assert ate_rmse(poses[tracked], seq.poses[tracked], align=True) < 0.05
    assert port.loop_closer is None or port.loop_closer.loops_closed == 0
    assert ref.loop_closer is None or ref.loop_closer.loops_closed == 0
    assert ([i for i, r in enumerate(port.results) if r.is_keyframe]
            == [i for i, r in enumerate(ref.results) if r.is_keyframe])
