"""The mapping slice end to end: the port's RGB-D session with local mapping
on (loop closing off) against the reference package's, 18 frames of the
320x240 textured dolly with the same configuration. The last two tests
are `tests/test_e2e_rgbd.py`'s tracking-ATE and exposure-drift sessions,
run on the port and marked slow like the originals."""

import numpy as np
import pytest

from orbslam2_tpu.config import (
    CameraConfig, MapConfig, OrbConfig, SlamConfig, Sensor, SolverConfig, TrackingConfig,
)
from orbslam2_tpu.io import synthetic
from orbslam2_tpu.pipeline.system import System as JSystem
from orbslam2_tpu.utils.evaluation import ate_rmse
from orbslam2_tpu_torch.pipeline.system import System as TSystem
from orbslam2_tpu_torch.pipeline.tracking import TrackState
from tests.torch_threads import share_cores
from tests.torch_config import port_config

share_cores()

CFG = SlamConfig(
    sensor=Sensor.RGBD,
    camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, width=320, height=240),
    orb=OrbConfig(num_features=300, feature_slots=320, candidates_per_level=2048),
    map=MapConfig(max_keyframes=32, max_points=8192, max_local_points=2048),
    tracking=TrackingConfig(th_depth=40.0),
    solver=SolverConfig(ba_max_points=2048, local_ba_iters_first=3, local_ba_iters_second=4,
                        ba_max_local_kfs=16, ba_max_fixed_kfs=16),
)
N_FRAMES = 18


def _run(slam, seq, n=N_FRAMES):
    for i in range(n):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    return slam.frame_poses()


@pytest.fixture(scope="module")
def sessions():
    seq = synthetic.textured_sequence(n_frames=N_FRAMES, kind="forward", cam=CFG.camera)
    ref = JSystem(CFG, enable_mapping=True, enable_loop_closing=False)
    port = TSystem(port_config(CFG), device="cpu", enable_mapping=True, enable_loop_closing=False)
    return seq, ref, _run(ref, seq), port, _run(port, seq)


def _kf_frames(slam):
    return [i for i, r in enumerate(slam.results) if r.is_keyframe]


def test_keyframes_at_the_reference_frames(sessions):
    """Frame 0 initialises; local BA runs at the keyframes of frames 6
    and 17, as in the reference."""
    _, ref, _, port, _ = sessions
    assert _kf_frames(port) == _kf_frames(ref) == [0, 6, 17]
    assert port.num_keyframes() == ref.num_keyframes() == 3
    assert [e["frame_id"] for e in port.log.of("keyframe")] == [0, 6, 17]


def test_map_size_matches_reference(sessions):
    _, ref, _, port, _ = sessions
    n_ref = ref.num_points()
    assert abs(port.num_points() - n_ref) <= 0.01 * n_ref, (port.num_points(), n_ref)
    assert n_ref > 400


def test_per_frame_poses_match_reference(sessions):
    """Translation within 5 mm and rotation within 0.2 degrees per frame,
    every frame tracked, ATE < 0.03 m."""
    seq, _, (_, pj, tj), port, (_, pt, tt) = sessions
    assert tj.all() and tt.all()
    assert port.get_tracking_state() == TrackState.OK
    dt = np.linalg.norm(pj[:, :3, 3] - pt[:, :3, 3], axis=1)
    R = np.einsum("nji,njk->nik", pj[:, :3, :3], pt[:, :3, :3])
    deg = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert dt.max() < 5e-3, dt
    assert deg.max() < 0.2, deg
    assert ate_rmse(pt, seq.poses, align=True) < 0.03   # the reference gives 0.0073 m


def test_save_keyframe_trajectory_tum(sessions, tmp_path):
    from orbslam2_tpu.io.trajectory import load_tum

    _, ref, _, port, _ = sessions
    path = tmp_path / "kf.txt"
    port.save_keyframe_trajectory_tum(str(path))
    ts, poses = load_tum(str(path))
    np.testing.assert_array_equal(ts, [0, 6, 17])
    np.testing.assert_allclose(poses, port.map.kf_Tcw[:3].numpy(), atol=1e-5)


def test_synchronous_keyframe_path_matches_reference():
    """Every frame through `System._track`, the synchronous path: the
    tracker requests keyframes and `_handle_kf_request` runs
    `keyframe_full_step` (BA from the third keyframe on). Same keyframes,
    points and poses (5 mm) as the reference's synchronous path."""
    import jax.numpy as jnp

    seq = synthetic.textured_sequence(n_frames=N_FRAMES, kind="forward", cam=CFG.camera)
    ref = JSystem(CFG, enable_mapping=True, enable_loop_closing=False)
    port = TSystem(port_config(CFG), device="cpu", enable_mapping=True, enable_loop_closing=False)
    for i in range(N_FRAMES):
        img, depth = seq.frame(i)
        ref._track(ref.builder.rgbd(jnp.asarray(img), jnp.asarray(depth), i / 30.0))
        port._track(port.builder.rgbd(port._as_tensor(img), port._as_tensor(depth), i / 30.0))
    assert _kf_frames(port) == _kf_frames(ref)
    assert len(_kf_frames(port)) >= 3
    assert port.num_points() == ref.num_points()
    _, pj, tj = ref.frame_poses()
    _, pt, tt = port.frame_poses()
    assert tj.all() and tt.all()
    assert np.abs(pt[:, :3, 3] - pj[:, :3, 3]).max() < 5e-3


def small_cfg():
    """`tests/test_e2e_rgbd.py`'s TUM-like configuration."""
    return SlamConfig(
        sensor=Sensor.RGBD,
        camera=CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0, fps=30.0),
        orb=OrbConfig(num_features=600, feature_slots=640, candidates_per_level=2048),
        map=MapConfig(max_keyframes=32, max_points=8192, max_local_points=4096),
        tracking=TrackingConfig(th_depth=40.0),
    )


@pytest.mark.slow
def test_rgbd_tracking_ate():
    cfg = small_cfg()
    seq = synthetic.textured_sequence(n_frames=30, kind="forward", cam=cfg.camera)
    slam = TSystem(port_config(cfg), device="cpu", enable_mapping=True, enable_loop_closing=False)
    _, poses, tracked = _run(slam, seq, len(seq))
    assert slam.get_tracking_state() == TrackState.OK
    assert tracked.all(), f"lost tracking on {np.count_nonzero(~tracked)} frames"
    rmse = ate_rmse(poses, seq.poses, align=True)
    assert rmse < 0.03, rmse
    n_kf = slam.num_keyframes()
    assert 2 <= n_kf <= len(seq) // 2, n_kf
    assert slam.num_points() > 500


@pytest.mark.slow
def test_rgbd_exposure_drift():
    """A +-10 % exposure swing across the run must not lose tracking."""
    cfg = small_cfg()
    seq = synthetic.textured_sequence(n_frames=20, kind="forward", cam=cfg.camera,
                                      exposure_drift=0.10)
    slam = TSystem(port_config(cfg), device="cpu", enable_mapping=True, enable_loop_closing=False)
    _, poses, tracked = _run(slam, seq, len(seq))
    assert tracked.all()
    rmse = ate_rmse(poses, seq.poses, align=True)
    assert rmse < 0.04, rmse
