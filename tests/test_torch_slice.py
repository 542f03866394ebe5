"""The slice end to end: the port's RGB-D tracking session (mapping and
loop closing off) against the reference package's, same 6-frame textured
sequence, same configuration."""

import numpy as np
import pytest

from orbslam2_tpu.config import CameraConfig, MapConfig, OrbConfig, SlamConfig, Sensor, TrackingConfig
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
)
N_FRAMES = 6


def _run(slam, seq):
    for i in range(N_FRAMES):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    return slam.frame_poses()


@pytest.fixture(scope="module")
def sessions():
    seq = synthetic.textured_sequence(n_frames=N_FRAMES, kind="forward", cam=CFG.camera)
    ref = JSystem(CFG, enable_mapping=False, enable_loop_closing=False)
    port = TSystem(port_config(CFG), device="cpu", enable_mapping=False, enable_loop_closing=False)
    return seq, ref, _run(ref, seq), port, _run(port, seq)


def test_port_tracks_every_frame(sessions):
    seq, _, _, port, (ts, poses, tracked) = sessions
    assert tracked.all(), tracked
    assert port.get_tracking_state() == TrackState.OK
    assert poses.shape == (N_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert ate_rmse(poses, seq.poses, align=True) < 0.03  # the reference gives 0.0041 m


def test_per_frame_poses_match_reference(sessions):
    """Translation within 5 mm and rotation within 0.2 degrees per frame."""
    _, _, (_, pj, tj), _, (_, pt, tt) = sessions
    assert tj.all() and tt.all()
    dt = np.linalg.norm(pj[:, :3, 3] - pt[:, :3, 3], axis=1)
    R = np.einsum("nji,njk->nik", pj[:, :3, :3], pt[:, :3, :3])
    deg = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert dt.max() < 5e-3, dt
    assert deg.max() < 0.2, deg


def test_session_counts_match_reference(sessions):
    _, ref, _, port, _ = sessions
    assert port.num_keyframes() == ref.num_keyframes() == 1
    assert port.num_points() == ref.num_points()
    assert [r.num_inliers for r in port.results] == [r.num_inliers for r in ref.results]


def test_save_trajectory_tum(sessions, tmp_path):
    from orbslam2_tpu.io.trajectory import load_tum

    _, _, _, port, (ts, poses, _) = sessions
    path = tmp_path / "traj.txt"
    port.save_trajectory_tum(str(path))
    t_loaded, p_loaded = load_tum(str(path))
    np.testing.assert_allclose(t_loaded, ts, atol=1e-6)
    np.testing.assert_allclose(p_loaded, poses, atol=1e-5)
