"""Local mapping, function by function: the port against the reference on
a map the reference built (two keyframes of the 640x480 textured dolly,
`tests/test_e2e_rgbd.py`'s configuration: at 320x240 the forward motion's
epipole veto leaves triangulation almost nothing to do), carried across
with `convert.py`.

Tolerances: integer fields (bindings, observation tables, counters) are
equal; float fields agree to 1e-5, float32 arithmetic in another order.
After local BA, poses agree to 1e-4, the BA parity of `test_torch_ba.py`.
Points, from BA or triangulation, agree to max(1e-3 m, 5e-4 z^2), z their
distance in metres from the first keyframe: two keyframes a few
centimetres apart fix a point's depth through a disparity that falls as
1/z, so float32 rounding moves it as z^2. Near points agree to 1e-3 m;
at 17 m the reference itself lies 8.5 cm from a float64 solve
(2.8e-4 z^2) and the port 3.6 cm.

The reference never refreshes point 0's statistics when the list of
points holds -1 entries: `recompute_point_stats` maps them to point 0 and
scatters the old value back, and on XLA's CPU the last of the duplicate
writes wins. The port writes only the valid entries. The rows of point 0
in mp_desc / mp_normal / mp_min_dist / mp_max_dist are therefore compared
apart (`test_recompute_point_stats_fillers`).

The last tests are `tests/test_map_state.py`'s recycling, scrub,
reparenting, seq-age and pressure-cull cases, run on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import (
    CameraConfig, MapConfig, OrbConfig, SlamConfig, Sensor, SolverConfig, TrackingConfig,
)
from orbslam2_tpu.geometry import camera as jcam
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry import triangulate as jtri
from orbslam2_tpu.io import synthetic
from orbslam2_tpu.ops import match as jmatch
from orbslam2_tpu.pipeline import fused as jfused
from orbslam2_tpu.pipeline import local_mapping as jlm
from orbslam2_tpu.pipeline.system import System as JSystem
from orbslam2_tpu.slam_map import map_state as jms
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.geometry import triangulate as ttri
from orbslam2_tpu_torch.ops import match as tmatch
from orbslam2_tpu_torch.pipeline import fused as tfused
from orbslam2_tpu_torch.pipeline import local_mapping as tlm
from orbslam2_tpu_torch.slam_map import map_state as tms
from tests.torch_threads import share_cores

share_cores()

CFG = SlamConfig(
    sensor=Sensor.RGBD,
    camera=CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0, fps=30.0),
    orb=OrbConfig(num_features=600, feature_slots=640, candidates_per_level=2048),
    map=MapConfig(max_keyframes=32, max_points=8192, max_local_points=4096),
    tracking=TrackingConfig(th_depth=40.0),
    solver=SolverConfig(ba_max_points=2048, local_ba_iters_first=3, local_ba_iters_second=4,
                        ba_max_local_kfs=16, ba_max_fixed_kfs=16),
)
FLOAT_FIELDS = ("kf_Tcw", "kf_xy", "kf_ur", "kf_depth", "kf_angle", "mp_pos", "mp_normal",
                "mp_min_dist", "mp_max_dist")
KF_KWARGS = dict(
    scale_factor_last=float(1.2**7), baseline=0.1, covis_threshold=15, n_neighbors=5,
    num_levels=8, max_local=16, max_fixed=16, max_points=2048, obs_slots=8, iters1=3,
    iters2=4, recycle_min_age=24,
)


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def ref():
    """The reference session after its second keyframe (frames 0 and 4),
    the reference's frame 10 and the tracking result on it, and a
    probation window of the points keyframe 1 created."""
    seq = synthetic.textured_sequence(n_frames=11, kind="forward", cam=CFG.camera)
    slam = JSystem(CFG, enable_mapping=True, enable_loop_closing=False)
    for i in range(5):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    assert [i for i, r in enumerate(slam.results) if r.is_keyframe] == [0, 4]
    t = slam.tracker
    mapper = slam.local_mapper
    map_np = _np(slam.map)
    frame = slam.builder.rgbd(jnp.asarray(seq.frame(10)[0]), jnp.asarray(seq.frame(10)[1]), 10 / 30)
    _, out = jfused.track_step(
        jms.MapState(**{k: jnp.array(v) for k, v in map_np.items()}), frame,
        t.last_frame.xy, t.last_point_idx, t.last_frame.octave, t.last_frame.angle,
        t.last_frame.desc, t.last_Tcw, jnp.eye(4), jnp.asarray(False), jnp.int32(t.ref_kf),
        t.K, t._params, max_local_kfs=80, max_local_points=4096, num_levels=8,
    )
    assert int(out.n_inliers) > 100
    window = np.full(mapper.RECENT_WINDOW, -1, np.int32)
    young = np.flatnonzero(map_np["mp_valid"] & (map_np["mp_first_kf"] == 1))
    assert len(young) > 100
    window[: len(young)] = young
    return dict(
        map=map_np, K=t.K, params=t._params, frame=frame, Tcw=out.Tcw, point_idx=out.point_idx,
        window=window, scale_factors=mapper.scale_factors,
        level_sigma2=mapper.level_sigma2, inv_sigma2=mapper.inv_sigma2,
        bounds=tuple(float(b) for b in t.bounds),
    )


def jmap(ref):
    return jms.MapState(**{k: jnp.array(v) for k, v in ref["map"].items()})


def tmap(ref):
    return convert.map_state_from_numpy(ref["map"], "cpu")


def tt(x, dtype=None):
    out = convert.to_tensor(x, "cpu")
    return out if dtype is None else out.to(dtype)


def port_args(ref):
    return (convert.intrinsics_from_numpy(_np(ref["K"]), "cpu"),
            convert.track_params_from_numpy(_np(ref["params"]), "cpu"))


STAT_FIELDS = ("mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist")


def assert_points_match(got, want):
    """Points [N, 3] to max(1e-3 m, 5e-4 z^2) (see the module docstring)."""
    err = np.linalg.norm(got - want, axis=-1)
    tol = np.maximum(1e-3, 5e-4 * np.sum(want**2, axis=-1))
    bad = np.flatnonzero(err > tol)
    assert len(bad) == 0, (bad[:10], err[bad][:10], tol[bad][:10])


def assert_maps_match(got: tms.MapState, want, ba: bool = False, skip_point0_stats: bool = False):
    """Integer fields equal, float fields to 1e-5; after a step with BA,
    poses to 1e-4, points by `assert_points_match` and scale bands to a
    relative 1e-3. `skip_point0_stats` leaves out
    point 0's statistics, which the reference does not refresh when the
    point list holds -1 entries."""
    got = convert.map_state_to_numpy(got)
    for name, w in _np(want).items():
        g = got[name]
        if skip_point0_stats and name in STAT_FIELDS:
            g, w = g[1:], w[1:]
        if ba and name == "mp_pos":
            assert_points_match(g, w)
        elif ba and name in ("mp_min_dist", "mp_max_dist"):
            # a new point's scale band is its distance from the keyframe,
            # so it carries the relative error of the triangulated position
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=name)
        elif name in FLOAT_FIELDS:
            atol = 1e-4 if ba and name == "kf_Tcw" else 1e-5
            np.testing.assert_allclose(g, w, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# geometry and matching
# ---------------------------------------------------------------------------


def test_triangulate_matches_reference(rng):
    """DLT of noisy projections of points 2-8 m in front of two cameras
    0.5 m apart, to a relative 1e-4 (float32 normal equations); a zero
    projection matrix makes every system singular, which must give the
    [0, 0, -1] sentinel on both sides."""
    Kj = jcam.Intrinsics.from_config(CFG.camera)
    Kt = convert.intrinsics_from_numpy(_np(Kj), "cpu")
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jse3.exp_se3(jnp.asarray([0.5, 0.0, 0.05, 0.0, 0.03, 0.0], jnp.float32)))
    pw = np.c_[rng.uniform(-2, 2, 64), rng.uniform(-1.5, 1.5, 64), rng.uniform(2, 8, 64)]
    pw = pw.astype(np.float32)

    def pix(T):
        pc = pw @ T[:3, :3].T + T[:3, 3]
        uv = np.c_[480.0 * pc[:, 0] / pc[:, 2] + 319.5, 480.0 * pc[:, 1] / pc[:, 2] + 239.5]
        return (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)

    uv1, uv2 = pix(T1), pix(T2)
    want = np.asarray(jtri.triangulate_two_view(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(T1),
                                                jnp.asarray(T2), Kj))
    got = ttri.triangulate_two_view(tt(uv1), tt(uv2), tt(T1), tt(T2), Kt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    P0 = np.zeros((3, 4), np.float32)
    want_d = np.asarray(jtri.triangulate_dlt(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(P0),
                                             jnp.asarray(P0)))
    got_d = ttri.triangulate_dlt(tt(uv1), tt(uv2), tt(P0), tt(P0)).numpy()
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_d, np.tile([0.0, 0.0, -1.0], (64, 1)))
    c2 = (-T2[:3, :3].T @ T2[:3, 3]).astype(np.float32)
    np.testing.assert_allclose(
        ttri.parallax_cos(tt(want), tt(np.zeros(3, np.float32)), tt(c2)).numpy(),
        np.asarray(jtri.parallax_cos(jnp.asarray(want), jnp.zeros(3), jnp.asarray(c2))),
        atol=1e-6,
    )


def test_epipolar_distance_and_fundamental_match_reference(ref):
    Kt, _ = port_args(ref)
    T = ref["map"]["kf_Tcw"]
    Fj = np.asarray(jlm.fundamental_from_poses(jnp.asarray(T[1]), jnp.asarray(T[0]), ref["K"]))
    Ft = tlm.fundamental_from_poses(tt(T[1]), tt(T[0]), Kt).numpy()
    np.testing.assert_allclose(Ft, Fj, rtol=1e-4, atol=1e-9)
    xy1, xy2 = ref["map"]["kf_xy"][1], ref["map"]["kf_xy"][0]
    want = np.asarray(jmatch.epipolar_distance2(jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(Fj)))
    got = tmatch.epipolar_distance2(tt(xy1), tt(xy2), tt(Fj)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_triangulate_pair_matches_reference(ref):
    """f2 and ok equal; pw by `assert_points_match`, where ok. Both keyframes'
    bindings are cleared first, so every feature is a candidate (the map
    as it stood before keyframe 1's mapping step, less its depth seeds)."""
    Kt, pt = port_args(ref)
    cleared = dict(ref["map"])
    cleared["kf_point_idx"] = ref["map"]["kf_point_idx"].copy()
    cleared["kf_point_idx"][:2] = -1
    st_j = jms.MapState(**{k: jnp.array(v) for k, v in cleared.items()})
    want = jlm.triangulate_pair(st_j, jnp.int32(1), jnp.int32(0), ref["K"],
                                ref["scale_factors"], ref["level_sigma2"], jnp.float32(0.1))
    got = tlm.triangulate_pair(convert.map_state_from_numpy(cleared, "cpu"), 1, torch.tensor([0]),
                               Kt, pt.scale_factors, tt(ref["level_sigma2"]), 0.1)
    f2, pw, ok, dist1 = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), f2)
    np.testing.assert_array_equal(got[2].numpy(), ok)
    assert ok.sum() > 10
    assert_points_match(got[1].numpy()[ok], pw[ok])


@pytest.mark.parametrize("src,dst", [(1, 0), (0, 1)])
def test_fuse_match_matches_reference(ref, src, dst):
    """The feature each candidate point fuses into, equal."""
    Kt, pt = port_args(ref)
    pid = ref["map"]["kf_point_idx"][src]
    want = np.asarray(jlm.fuse_match(jmap(ref), jnp.asarray(pid), jnp.asarray(pid >= 0), jnp.int32(dst),
                                     ref["K"], ref["scale_factors"], ref["bounds"]))
    got = tlm.fuse_match(tmap(ref), tt(pid), tt(pid >= 0), dst, Kt, pt.scale_factors, ref["bounds"])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("src,dst", [(1, 0), (0, 1)])
def test_fuse_points_into_kf_matches_reference(ref, src, dst):
    Kt, pt = port_args(ref)
    pid = ref["map"]["kf_point_idx"][src]
    want = jlm.fuse_points_into_kf(jmap(ref), jnp.asarray(pid), jnp.asarray(pid >= 0), jnp.int32(dst),
                                   ref["K"], ref["scale_factors"], ref["bounds"])
    got = tmap(ref)
    tlm.fuse_points_into_kf(got, tt(pid), tt(pid >= 0), dst, Kt, pt.scale_factors, ref["bounds"])
    assert_maps_match(got, want)


# ---------------------------------------------------------------------------
# binding primitives
# ---------------------------------------------------------------------------


def test_bind_points_to_kf_matches_reference(ref):
    """Unbound features of keyframe 1 get points, two candidates share a
    slot (the first wins) and one point is already observed there."""
    kpi = ref["map"]["kf_point_idx"]
    free = np.flatnonzero((kpi[1] < 0) & ref["map"]["kf_feat_valid"][1])[:6]
    pts = np.flatnonzero(ref["map"]["mp_valid"])
    feat = np.r_[free, free[0], np.flatnonzero(kpi[1] >= 0)[0]].astype(np.int32)
    pids = np.r_[pts[-6:], pts[-7], kpi[1][feat[-1]]].astype(np.int32)
    mask = np.ones(len(feat), bool)
    want = jlm.bind_points_to_kf(jmap(ref), jnp.int32(1), jnp.asarray(feat), jnp.asarray(pids),
                                 jnp.asarray(mask))
    got = tmap(ref)
    tlm.bind_points_to_kf(got, 1, tt(feat), tt(pids), tt(mask))
    assert_maps_match(got, want)


def test_erase_and_invalidate_match_reference(ref):
    kpi = ref["map"]["kf_point_idx"]
    bound = np.flatnonzero(kpi[1] >= 0)[::7]
    pids = kpi[1][bound].astype(np.int32)
    kfs = np.full(len(pids), 1, np.int32)
    mask = np.arange(len(pids)) % 3 != 0
    want = jlm.erase_observations(jmap(ref), jnp.asarray(pids), jnp.asarray(kfs), jnp.asarray(mask))
    got = tmap(ref)
    tlm.erase_observations(got, tt(pids), tt(kfs), tt(mask))
    assert_maps_match(got, want)
    want = jlm.invalidate_points(want, jnp.asarray(pids), jnp.asarray(~mask))
    tlm.invalidate_points(got, tt(pids), tt(~mask))
    assert_maps_match(got, want)


def test_cull_points_matches_reference(ref):
    window = ref["window"]
    assert (window >= 0).sum() > 50
    for now in (2, 4):
        want_st, want_keep = jlm.cull_points(jmap(ref), jnp.asarray(window), jnp.int32(now))
        got = tmap(ref)
        keep = tlm.cull_points(got, tt(window), torch.tensor(now, dtype=torch.int32))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
        assert_maps_match(got, want_st)


def test_ensure_free_slots_matches_reference(ref):
    """A headroom past the free count forces the tiered eviction; the
    scores tie often, so this also holds the slot-order tie-break."""
    n_free = int((~ref["map"]["mp_valid"]).sum())
    protect = np.zeros(len(ref["map"]["mp_valid"]), bool)
    protect[::5] = True
    want = jlm.ensure_free_slots(jmap(ref), jnp.int32(30), headroom=n_free + 150,
                                 protect=jnp.asarray(protect), min_age=24)
    got = tmap(ref)
    tlm.ensure_free_slots(got, torch.tensor(30, dtype=torch.int32), headroom=n_free + 150,
                          protect=tt(protect), min_age=24)
    assert int((~got.mp_valid).sum()) == n_free + 150
    assert_maps_match(got, want)


# ---------------------------------------------------------------------------
# map maintenance
# ---------------------------------------------------------------------------


def test_recompute_point_stats_matches_reference(ref):
    """Keyframe 1's bindings, -1 entries included, as the keyframe step
    passes them."""
    pids = ref["map"]["kf_point_idx"][1].copy()
    want = jms.recompute_point_stats(jmap(ref), jnp.asarray(pids), ref["scale_factors"])
    got = tmap(ref)
    tms.recompute_point_stats(got, tt(pids), tt(ref["scale_factors"]))
    assert_maps_match(got, want, skip_point0_stats=True)


def test_recompute_point_stats_fillers(ref):
    """Point 0 is bound in keyframe 1. Given the bindings with their -1
    entries, the reference leaves point 0's statistics stale (the fillers'
    writes of the old value win); given only the bound ids, it refreshes
    them. The port refreshes them either way."""
    pids = ref["map"]["kf_point_idx"][1].copy()
    assert 0 in pids and (pids < 0).any()
    sf = ref["scale_factors"]
    with_fillers = jms.recompute_point_stats(jmap(ref), jnp.asarray(pids), sf)
    compact = jms.recompute_point_stats(jmap(ref), jnp.asarray(pids[pids >= 0]), sf)
    got = tmap(ref)
    tms.recompute_point_stats(got, tt(pids), tt(sf))
    np.testing.assert_array_equal(np.asarray(with_fillers.mp_normal[0]), ref["map"]["mp_normal"][0])
    assert not np.allclose(np.asarray(compact.mp_normal[0]), ref["map"]["mp_normal"][0], atol=1e-4)
    assert_maps_match(got, compact)


def test_rebuild_observations_matches_reference(ref):
    want, want_n = jms.rebuild_observations(jmap(ref))
    got = tmap(ref)
    n = tms.rebuild_observations(got)
    assert int(n) == int(want_n)
    assert_maps_match(got, want)


def test_covisible_keyframes_matches_reference(ref):
    for k in (0, 1):
        np.testing.assert_array_equal(
            tms.covisible_keyframes(tmap(ref), k).numpy(),
            np.asarray(jms.covisible_keyframes(jmap(ref), k)),
        )


def test_local_ba_matches_reference(ref):
    """The assembled problem equal (cameras, points, observation tables),
    then BA + write-back to the BA tolerance."""
    Kt, _ = port_args(ref)
    jprob, jcams, jpres, jpts, jok = jlm.build_local_ba_problem(
        jmap(ref), jnp.int32(1), ref["inv_sigma2"], max_local=16, max_fixed=16, max_points=2048,
        obs_slots=8)
    got_map = tmap(ref)
    tprob, tcams, tpres, tpts, tok = tlm.build_local_ba_problem(
        got_map, 1, tt(ref["inv_sigma2"]), max_local=16, max_fixed=16, max_points=2048, obs_slots=8)
    for a, b in [(tcams, jcams), (tpres, jpres), (tpts, jpts), (tok, jok)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in jprob._fields:
        g, w = getattr(tprob, name).numpy(), np.asarray(getattr(jprob, name))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    want = jfused.local_ba_step(jmap(ref), jnp.int32(1), ref["inv_sigma2"], ref["K"],
                                max_local=16, max_fixed=16, max_points=2048, obs_slots=8,
                                iters1=3, iters2=4)
    tfused.local_ba_step(got_map, 1, tt(ref["inv_sigma2"]), Kt, max_local=16, max_fixed=16,
                         max_points=2048, obs_slots=8, iters1=3, iters2=4)
    assert_maps_match(got_map, want, ba=True)


def test_keyframe_redundancy_matches_reference(ref):
    st_t, st_j = tmap(ref), jmap(ref)
    for k in (0, 1, 2):
        np.testing.assert_allclose(float(tlm.keyframe_redundancy(st_t, k)),
                                   float(jlm.keyframe_redundancy(st_j, jnp.int32(k))), atol=1e-6)
    np.testing.assert_allclose(tlm.kf_cull_pressure_scores(st_t).numpy(),
                               np.asarray(jlm.kf_cull_pressure_scores(st_j)), atol=1e-6)


def test_remove_keyframe_matches_reference(ref):
    want = jlm.remove_keyframe(jmap(ref), jnp.int32(1))
    got = tmap(ref)
    tlm.remove_keyframe(got, 1)
    assert_maps_match(got, want)


def test_keyframe_full_step_matches_reference(ref):
    """Frame 10 inserted as a third keyframe: keyframe id, new points,
    probation keep mask, bindings and observation tables equal; poses and
    points to the BA tolerance."""
    Kt, pt = port_args(ref)
    frame = ref["frame"]
    want = jfused.keyframe_full_step(
        jmap(ref), frame, ref["Tcw"], ref["point_idx"], jnp.asarray(ref["window"]), ref["K"],
        ref["params"], ref["level_sigma2"], ref["inv_sigma2"], run_ba=True, **KF_KWARGS)
    got_map = tmap(ref)
    got = tfused.keyframe_full_step(
        got_map, convert.frame_from_numpy(_np(frame), "cpu"), tt(ref["Tcw"]), tt(ref["point_idx"]),
        ref["window"], Kt, pt, tt(ref["level_sigma2"]), tt(ref["inv_sigma2"]), run_ba=True,
        **KF_KWARGS)
    st_j, kf_j, new_j, keep_j, Tcw_j, bind_j, cull_ids_j, cull_red_j = want
    kf_t, new_t, keep_t, Tcw_t, bind_t, cull_ids_t, cull_red_t = got
    assert kf_t == int(kf_j) == 2
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    assert (new_t >= 0).sum() > 10
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(bind_t.numpy(), np.asarray(bind_j))
    np.testing.assert_allclose(Tcw_t.numpy(), np.asarray(Tcw_j), atol=1e-4)
    np.testing.assert_array_equal(cull_ids_t.numpy(), np.asarray(cull_ids_j))
    np.testing.assert_allclose(cull_red_t.numpy(), np.asarray(cull_red_j), atol=1e-6)
    assert_maps_match(got_map, st_j, ba=True, skip_point0_stats=True)


# ---------------------------------------------------------------------------
# `tests/test_map_state.py` cases on the port
# ---------------------------------------------------------------------------

MCFG = MapConfig(max_keyframes=8, max_points=256)
OCFG = OrbConfig(num_features=30, feature_slots=32)


def blank():
    return tms.allocate(MCFG, OCFG, "cpu", obs_slots=4)


def add_kf(st, rng, frame_id=0, point_idx=None, n_feat=32):
    S = OCFG.feature_slots
    pi = torch.full((S,), -1, dtype=torch.int32) if point_idx is None else point_idx
    return tms.add_keyframe(
        st, frame_id, torch.eye(4), torch.from_numpy(rng.uniform(0, 640, (S, 2)).astype(np.float32)),
        torch.full((S,), -1.0), torch.full((S,), -1.0), torch.zeros(S, dtype=torch.int32),
        torch.zeros(S), torch.from_numpy(rng.integers(0, 2**32, (S, 8), dtype=np.uint32).view(np.int32)),
        torch.arange(S) < n_feat, pi,
    )


def add_pts(st, k, n, pos=None, feat=None):
    pos = torch.ones((n, 3)) if pos is None else pos
    feat = torch.arange(n, dtype=torch.int32) if feat is None else feat
    return tms.add_points(st, pos, torch.ones(n, dtype=torch.bool), k, feat,
                          torch.zeros((n, 8), dtype=torch.int32), torch.zeros((n, 3)),
                          torch.zeros(n), torch.ones(n), torch.full((n,), -1.0))


def test_capacity_pressure_recycling(rng):
    """Tiered eviction: mature weak points first, the young frontier next,
    anchors last; protected points are never touched; a pool with room is
    left alone."""
    st = blank()
    k0 = add_kf(st, rng)
    P = st.capacity_mp
    for b in range(8):
        add_pts(st, k0, 32, pos=torch.ones((32, 3)) * (b + 1))
    assert int(st.mp_valid.sum()) == P
    add_kf(st, rng, frame_id=1)
    add_kf(st, rng, frame_id=2)
    st.mp_obs_kf[:10, :3] = torch.arange(3, dtype=torch.int32)
    st.mp_n_obs[:10] = 9

    def copy(s):
        return tms.MapState(**{k: v.clone() for k, v in vars(s).items()})

    protect = torch.zeros(P, dtype=torch.bool)
    protect[10:20] = True
    out = copy(st)
    tlm.ensure_free_slots(out, torch.tensor(40), headroom=64, protect=protect)
    assert P - int(out.mp_valid.sum()) == 64
    assert bool(out.mp_valid[:20].all())
    dead = ~out.mp_valid
    assert (out.mp_obs_kf[dead] < 0).all()
    kpi = out.kf_point_idx[0]
    assert out.mp_valid[kpi[kpi >= 0].long()].all()
    mix = copy(st)
    mix.mp_first_kf.copy_(torch.where(torch.arange(P) < P // 2, 0, 38))
    mix.mp_obs_kf.fill_(-1)
    tlm.ensure_free_slots(mix, torch.tensor(40), headroom=64)
    assert bool(mix.mp_valid[P // 2:].all()), "frontier eaten before mature"
    young = copy(st)
    young.mp_first_kf.fill_(39)
    young.mp_obs_kf.fill_(-1)
    tlm.ensure_free_slots(young, torch.tensor(40), headroom=64)
    assert P - int(young.mp_valid.sum()) == 64
    n_valid = int(out.mp_valid.sum())
    tlm.ensure_free_slots(out, torch.tensor(40), headroom=32)
    assert int(out.mp_valid.sum()) == n_valid


def test_invalidate_scrubs_overflowed_bindings(rng):
    """A point bound in more keyframes than its obs table holds loses every
    binding on invalidation, so a recycled slot is never aliased."""
    st = blank()
    k0 = add_kf(st, rng)
    pids = add_pts(st, k0, 8)
    pid0 = int(pids[0])
    for fid in range(1, 6):
        pi = torch.full((32,), -1, dtype=torch.int32)
        pi[0] = pid0
        add_kf(st, rng, frame_id=fid, point_idx=pi)
    assert int((st.kf_point_idx == pid0).sum()) == 6
    assert int((st.mp_obs_kf[pid0] >= 0).sum()) == 4
    tlm.invalidate_points(st, torch.tensor([pid0], dtype=torch.int32), torch.tensor([True]))
    assert not bool(st.mp_valid[pid0])
    assert int((st.kf_point_idx == pid0).sum()) == 0
    pids2 = add_pts(st, 0, 1, pos=torch.full((1, 3), 9.0), feat=torch.tensor([7], dtype=torch.int32))
    assert int(pids2[0]) == pid0
    refs = torch.nonzero(st.kf_point_idx == pid0)
    assert refs.shape[0] == 1 and tuple(refs[0].tolist()) == (0, 7)


def test_keyframe_slot_recycling(rng):
    st = blank()
    for fid in range(8):
        assert add_kf(st, rng, frame_id=fid) == fid
    assert int(st.num_kf) == 8
    assert add_kf(st, rng, frame_id=99) == st.capacity_kf   # full: dropped
    assert int(st.num_kf) == 8 and int(st.kf_frame_id[0]) == 0
    tlm.remove_keyframe(st, 3)
    assert add_kf(st, rng, frame_id=42) == 3
    assert bool(st.kf_valid[3]) and int(st.kf_frame_id[3]) == 42
    assert int(st.kf_seq[3]) == 8 and int(st.num_kf) == 9
    assert int(st.kf_parent[3]) == 7   # newest older keyframe, not slot order


def test_greedy_reparenting(rng):
    st = blank()
    for fid in range(4):
        add_kf(st, rng, frame_id=fid)
    st.kf_parent.copy_(torch.tensor([-1, 0, 1, 1] + [-1] * 4, dtype=torch.int32))
    covis = torch.zeros((8, 8), dtype=torch.int32)
    covis[2, 0] = covis[0, 2] = 20
    covis[3, 0] = covis[0, 3] = 5
    covis[3, 2] = covis[2, 3] = 30
    hub = tms.MapState(**{k: v.clone() for k, v in vars(st).items()})
    hub.covis.copy_(covis)
    tlm.remove_keyframe(hub, 1)
    assert int(hub.kf_parent[2]) == 0 and int(hub.kf_parent[3]) == 2
    st.covis.zero_()
    tlm.remove_keyframe(st, 1)
    assert int(st.kf_parent[2]) == 0 and int(st.kf_parent[3]) == 0


def test_point_age_uses_seq_not_slot(rng):
    st = blank()
    for fid in range(8):
        add_kf(st, rng, frame_id=fid)
    tlm.remove_keyframe(st, 1)
    k = add_kf(st, rng, frame_id=50)
    assert k == 1 and int(st.kf_seq[1]) == 8
    pids = add_pts(st, k, 4)
    assert (st.mp_first_kf[pids.long()] == 8).all()
    keep = tlm.cull_points(st, pids, torch.tensor(9, dtype=torch.int32))
    assert bool(st.mp_valid[pids.long()].all()) and bool(keep.all())


def test_pressure_cull_scores_protect(rng):
    st = blank()
    for fid in range(7):
        add_kf(st, rng, frame_id=fid)
    red = tlm.kf_cull_pressure_scores(st).numpy()
    assert red[0] == -1.0 and red[7] == -1.0
    assert (red[2:7] == -1.0).all()
    assert red[1] >= 0.0
