"""Tracking-stage parity on identical inputs: a map initialised by the
reference package and a frame it extracted are converted to the port
(`convert.py`), so extraction differences cannot hide tracking faults."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraConfig, MapConfig, OrbConfig, SlamConfig, Sensor, TrackingConfig
from orbslam2_tpu.io import synthetic
from orbslam2_tpu.pipeline import fused as jfused
from orbslam2_tpu.pipeline import tracking as jtrk
from orbslam2_tpu.pipeline.frame import FrameBuilder as JFrameBuilder
from orbslam2_tpu.slam_map import map_state as jms
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.pipeline import fused as tfused
from orbslam2_tpu_torch.pipeline import tracking as ttrk
from orbslam2_tpu_torch.pipeline.frame import FrameBuilder as TFrameBuilder
from orbslam2_tpu_torch.slam_map import map_state as tms
from tests.torch_config import port_config

CFG = SlamConfig(
    sensor=Sensor.RGBD,
    camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, width=320, height=240),
    orb=OrbConfig(num_features=300, feature_slots=320, candidates_per_level=2048),
    map=MapConfig(max_keyframes=32, max_points=8192, max_local_points=2048),
    tracking=TrackingConfig(th_depth=40.0),
)
FLOAT_FIELDS = ("kf_Tcw", "kf_xy", "kf_ur", "kf_depth", "kf_angle", "mp_pos", "mp_normal",
                "mp_min_dist", "mp_max_dist")


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def ref():
    """Reference map after RGB-D initialization on frame 0, and frame 2
    (two frames of motion) extracted by the reference."""
    seq = synthetic.textured_sequence(n_frames=3, kind="forward", cam=CFG.camera)
    builder = JFrameBuilder(CFG)
    tracker = jtrk.Tracker(CFG, builder, jms.allocate(CFG.map, CFG.orb))
    f0 = builder.rgbd(jnp.asarray(seq.frame(0)[0]), jnp.asarray(seq.frame(0)[1]), 0.0)
    assert tracker.process(f0).state == jtrk.TrackState.OK
    f2 = builder.rgbd(jnp.asarray(seq.frame(2)[0]), jnp.asarray(seq.frame(2)[1]), 2 / 30)
    tracker._ensure_params()
    return {"tracker": tracker, "f0": f0, "f2": f2, "map": _np(tracker.map)}


def _port_map(ref):
    return convert.map_state_from_numpy(ref["map"], "cpu")


def _port_frame(f):
    return convert.frame_from_numpy(_np(f), "cpu")


def test_stereo_initialize_builds_the_same_map(ref):
    """add_keyframe / add_points / observations / covisibility: the port's
    initialization on the reference's frame 0 gives the reference's map."""
    builder = TFrameBuilder(CFG, "cpu")
    tracker = ttrk.Tracker(port_config(CFG), builder, tms.allocate(CFG.map, CFG.orb, "cpu"))
    assert tracker.process(_port_frame(ref["f0"])).state == ttrk.TrackState.OK
    got = convert.map_state_to_numpy(tracker.map)
    for name, want in ref["map"].items():
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(got[name], want, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert int(got["num_mp"]) > 250


def test_map_state_round_trip(ref):
    """Same bits and dtypes back; the port's map is a copy, so its in-place
    updates never reach the reference's buffers."""
    port = _port_map(ref)
    back = convert.map_state_to_numpy(port)
    for name, want in ref["map"].items():
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    port.mp_found += 1
    np.testing.assert_array_equal(np.asarray(ref["tracker"].map.mp_found), ref["map"]["mp_found"])


def test_track_step_matches_reference(ref):
    """Tcw to atol 1e-4; >= 99 % of point bindings equal; inlier counts
    within 2; visibility counters equal except where bindings differ."""
    t = ref["tracker"]
    f2 = ref["f2"]
    K_t = convert.intrinsics_from_numpy(_np(t.K), "cpu")
    p_t = convert.track_params_from_numpy(_np(t._params), "cpu")
    st_t = _port_map(ref)
    lf = _port_frame(t.last_frame)
    out_t = tfused.track_step(
        st_t, _port_frame(f2), lf.xy, convert.to_tensor(t.last_point_idx, "cpu"),
        lf.octave, lf.angle, lf.desc, convert.to_tensor(t.last_Tcw, "cpu"), torch.eye(4),
        False, t.ref_kf, K_t, p_t,
        max_local_kfs=CFG.map.max_local_keyframes, max_local_points=CFG.map.max_local_points,
        num_levels=CFG.orb.num_levels,
    )
    donated = jms.MapState(*(jnp.array(x, copy=True) for x in t.map))
    st_j, out_j = jfused.track_step(
        donated, f2, t.last_frame.xy, t.last_point_idx, t.last_frame.octave,
        t.last_frame.angle, t.last_frame.desc, t.last_Tcw, jnp.eye(4), jnp.asarray(False),
        jnp.int32(t.ref_kf), t.K, t._params,
        max_local_kfs=CFG.map.max_local_keyframes, max_local_points=CFG.map.max_local_points,
        num_levels=CFG.orb.num_levels,
    )
    np.testing.assert_allclose(out_t.Tcw.numpy(), np.asarray(out_j.Tcw), atol=1e-4)
    same = out_t.point_idx.numpy() == np.asarray(out_j.point_idx)
    assert same.mean() >= 0.99, same.mean()
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= 2
    assert int(out_j.n_inliers) > 100
    assert bool(out_t.ok) == bool(out_j.ok)
    for name in ("ref_tracked", "close_tracked", "close_free"):
        assert abs(int(getattr(out_t, name)) - int(getattr(out_j, name))) <= 2, name
    if same.all():
        np.testing.assert_array_equal(st_t.mp_found.numpy(), np.asarray(st_j.mp_found))
        np.testing.assert_array_equal(st_t.mp_visible.numpy(), np.asarray(st_j.mp_visible))


def test_motion_model_match_matches_reference(ref):
    t = ref["tracker"]
    st = _port_map(ref)
    lf = _port_frame(t.last_frame)
    K_t = convert.intrinsics_from_numpy(_np(t.K), "cpu")
    sf = convert.to_tensor(t.scale_factors, "cpu")
    got, uv_t = ttrk.motion_model_match(
        torch.eye(4), lf.xy, convert.to_tensor(t.last_point_idx, "cpu"), lf.octave, lf.angle,
        lf.desc, st.mp_pos, st.mp_valid, _port_frame(ref["f2"]), K_t, sf, 7.0, 64,
    )
    want, uv_j = jtrk.motion_model_match(
        jnp.eye(4), t.last_frame.xy, t.last_point_idx, t.last_frame.octave, t.last_frame.angle,
        t.last_frame.desc, t.map.mp_pos, t.map.mp_valid, ref["f2"], t.K, t.scale_factors,
        jnp.float32(7.0), 64,
    )
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > 50


def test_local_map_stages_match_reference(ref):
    """gather_local_map (ties in the top-k broken alike), then
    search_local_points at the keyframe pose."""
    t = ref["tracker"]
    st = _port_map(ref)
    bind_np = np.asarray(t.last_point_idx).copy()
    bind_np[::3] = -1
    gj = jtrk.gather_local_map(t.map, jnp.asarray(bind_np), max_local_kfs=80, max_local_points=2048)
    gt = ttrk.gather_local_map(st, torch.from_numpy(bind_np), max_local_kfs=80, max_local_points=2048)
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    K_t = convert.intrinsics_from_numpy(_np(t.K), "cpu")
    sf = convert.to_tensor(t.scale_factors, "cpu")
    bj, vj = jtrk.search_local_points(
        t.map, gj[2], gj[3], t.last_Tcw, jnp.asarray(bind_np), ref["f2"], t.K, t.scale_factors,
        tuple(jnp.float32(b) for b in t.bounds), jnp.float32(1.0), num_levels=8, max_dist=64,
    )
    bt, vt = ttrk.search_local_points(
        st, gt[2], gt[3], torch.eye(4), torch.from_numpy(bind_np), _port_frame(ref["f2"]), K_t,
        sf, t.bounds, 1.0, num_levels=8, max_dist=64,
    )
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
