"""Loop closing and relocalization of the port against the reference, on
the same maps:

* a map of the 320x240 dolly (18 frames, mapping and loop closing on,
  built by the port) saved in the reference's `.npz` layout with its BoW
  database and loaded through both packages' `load_map`: the fused Sim3
  verification `_verify_candidate` with the reference's RANSAC draw (and
  on candidates thinned below 20 brute matches, which the port cuts after
  the match), the correction's device stages (`_propagate_neighborhood`,
  `build_essential_edges`, `_fuse_and_rebuild`), and `Tracker.relocalize`
  with the reference's EPnP draw;
* `tests/test_loop_solvers.py::TestCorrectLoopEndToEnd`'s drifted ring,
  corrected whole by both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraConfig, MapConfig, OrbConfig, SlamConfig, Sensor
from orbslam2_tpu.geometry import se3, sim3
from orbslam2_tpu.io import synthetic
from orbslam2_tpu.pipeline import loop_closing as jlc
from orbslam2_tpu.pipeline.system import System as JSystem
from orbslam2_tpu.pipeline.tracking import TrackState as JTrackState
from orbslam2_tpu.slam_map import map_state as jms
from orbslam2_tpu_torch import convert, profiling
from orbslam2_tpu_torch.geometry import sim3 as tsim3
from orbslam2_tpu_torch.pipeline import loop_closing as tlc
from orbslam2_tpu_torch.pipeline.system import System as TSystem
from orbslam2_tpu_torch.pipeline.tracking import TrackState
from tests.test_torch_mapping_slice import CFG, N_FRAMES
from tests.torch_config import port_config
from tests.torch_threads import share_cores

share_cores()

NL = CFG.orb.num_levels
SF = np.asarray([CFG.orb.scale_factor ** i for i in range(NL)], np.float32)
LEVEL_SIGMA2 = SF ** 2


def t(x):
    return convert.to_tensor(np.asarray(x), "cpu")


def port_map(jstate):
    return convert.map_state_from_numpy({k: np.asarray(v) for k, v in jstate._asdict().items()},
                                        "cpu")


def assert_maps_equal(port_state, jstate, fields=None, atol=0.0):
    ref = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    got = convert.map_state_to_numpy(port_state)
    for k in fields or got:
        if got[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], ref[k], atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """The port's 18-frame session, saved; the file loaded into a fresh
    port session and into a reference session."""
    seq = synthetic.textured_sequence(n_frames=N_FRAMES, kind="forward", cam=CFG.camera)
    port = TSystem(port_config(CFG), device="cpu")
    for i in range(N_FRAMES):
        img, depth = seq.frame(i)
        port.track_rgbd(img, depth, timestamp=i / 30.0)
    path = str(tmp_path_factory.mktemp("loopmap") / "map.npz")
    port.save_map(path)
    tport = TSystem(port_config(CFG), device="cpu")
    tport.load_map(path)
    ref = JSystem(CFG)
    ref.load_map(path)
    return seq, port, tport, ref, path


def test_map_with_database_loads_into_both_packages(loaded, tmp_path):
    """A file with a BoW database loads in either direction: the port's
    file into both packages, and the reference's re-save into the port,
    field for field, database and codebook included."""
    _, port, tport, ref, _ = loaded
    assert port.loop_closer is not None and ref.loop_closer is not None
    assert_maps_equal(tport.map, ref.map)
    present = port.loop_closer.db.present.numpy()
    assert present.sum() == 2        # the keyframes of frames 6 and 17
    for lc in (tport.loop_closer, ):
        np.testing.assert_array_equal(lc.db.present.numpy(), present)
        np.testing.assert_array_equal(lc.db.vectors.numpy(), port.loop_closer.db.vectors.numpy())
    np.testing.assert_array_equal(np.asarray(ref.loop_closer.db.vectors),
                                  port.loop_closer.db.vectors.numpy())
    np.testing.assert_array_equal(np.asarray(ref.loop_closer.codebook.fine),
                                  convert.to_numpy(port.loop_closer.codebook.fine, True))
    back = str(tmp_path / "ref.npz")
    ref.save_map(back)
    again = TSystem(port_config(CFG), device="cpu")
    again.load_map(back)
    assert_maps_equal(again.map, ref.map)
    np.testing.assert_array_equal(again.loop_closer.db.vectors.numpy(),
                                  np.asarray(ref.loop_closer.db.vectors))
    np.testing.assert_array_equal(again.loop_closer.idf.numpy(), np.asarray(ref.loop_closer.idf))


def test_database_rows_match_reference_vectors(loaded):
    """The rows the port's session wrote are the reference's `bow_vector`
    of the same keyframes (shipped vocabulary, idf)."""
    from orbslam2_tpu.vocab import bow as jbow

    _, port, _, ref, _ = loaded
    lc = ref.loop_closer
    for k in np.nonzero(port.loop_closer.db.present.numpy())[0]:
        want = jbow.bow_vector(ref.map.kf_desc[k], ref.map.kf_feat_valid[k], lc.codebook, lc.idf)
        np.testing.assert_allclose(port.loop_closer.db.vectors[k].numpy(), np.asarray(want),
                                   atol=1e-6)


def ref_sim3_samples(key, mask, iters=128):
    mask = np.asarray(mask)
    p = jnp.asarray(mask, jnp.float32) / max(int(mask.sum()), 1)
    return t(jax.random.choice(key, mask.shape[0], shape=(iters, 3), replace=True, p=p))


@pytest.mark.parametrize("cand", [0, 1])
def test_verify_candidate_matches_reference(loaded, cand):
    """The whole ComputeSim3 chain, the current keyframe (frame 17)
    against keyframes 0 and 1, with the reference's RANSAC draw: stats
    exact, S12 within 1e-4, the match and guided sets and the loop region
    exact."""
    _, _, tport, ref, _ = loaded
    kf = 2
    key = jax.random.PRNGKey(11 + cand)
    jK = ref.builder.K
    out_j = jlc._verify_candidate(ref.map, jnp.int32(kf), jnp.int32(cand), key, jK,
                                  jnp.asarray(SF), jnp.asarray(LEVEL_SIGMA2), ransac_iters=128,
                                  min_inliers=20, fix_scale=True, covis_threshold=15,
                                  num_levels=NL)
    out_t = tlc._verify_candidate(tport.map, kf, cand, lambda m: ref_sim3_samples(key, m),
                                  tport.builder.K, t(SF), t(LEVEL_SIGMA2), min_inliers=20,
                                  fix_scale=True, covis_threshold=15, num_levels=NL)
    stats_j, stats_t = np.asarray(out_j[0]), out_t[0].numpy()
    np.testing.assert_array_equal(stats_t, stats_j)
    assert stats_t[0] >= 20 and stats_t[1] >= 20 and stats_t[3] == 1
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), atol=1e-4)
    for a, b in zip(out_j[2:], out_t[2:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _thinned(ref, cand, keep=10):
    """The loaded map with all but `keep` of keyframe `cand`'s points
    invalid: the reference's copy and the port's, the same numbers."""
    pids = np.asarray(ref.map.kf_point_idx[cand])
    pids = pids[pids >= 0]
    valid = np.asarray(ref.map.mp_valid).copy()
    valid[pids[keep:]] = False
    jstate = ref.map._replace(mp_valid=jnp.asarray(valid))
    return jstate, port_map(jstate)


@pytest.mark.parametrize("cand", [0, 1])
def test_verify_candidate_cut_matches_reference(loaded, cand):
    """A candidate with fewer than 20 brute matches, keyframe 2 against a
    thinned keyframe 0 or 1: the port reads the reference's n_brute and
    its rejection, draws once with the brute match mask, runs nothing of
    the chain past `loop.verify.brute` and counts one `loop.verify.cut`;
    its other outputs keep the reference's shapes."""
    _, _, tport, ref, _ = loaded
    kf = 2
    jstate, tstate = _thinned(ref, cand)
    key = jax.random.PRNGKey(11 + cand)
    out_j = jlc._verify_candidate(jstate, jnp.int32(kf), jnp.int32(cand), key, ref.builder.K,
                                  jnp.asarray(SF), jnp.asarray(LEVEL_SIGMA2), ransac_iters=128,
                                  min_inliers=20, fix_scale=True, covis_threshold=15,
                                  num_levels=NL)
    n_brute, _, _, ok = np.asarray(out_j[0]).tolist()
    assert 0 < n_brute < 20 and ok == 0
    masks = []

    def draw(m):
        masks.append(m.clone())
        return ref_sim3_samples(key, m)

    profiling.take()
    profiling.enable()
    try:
        out_t = tport.loop_closer._run_verify(tstate, kf, cand, draw=draw)
    finally:
        profiling.disable()
    taken = profiling.take()
    assert out_t[0].tolist() == [n_brute, 0, 0, 0]
    assert len(masks) == 1 and int(masks[0].sum()) == n_brute
    assert [s.name for s in taken["spans"]] == ["loop.verify", "loop.verify.brute"]
    assert taken["counters"] == {"loop.verify.cut": 1}
    for a, b in zip(out_j[1:], out_t[1:]):
        assert tuple(b.shape) == np.asarray(a).shape


def test_cut_candidate_advances_the_draws_as_a_whole_chain(loaded):
    """The loop closer's generator after a candidate cut at the brute
    match is where it is after a candidate that ran the whole chain: one
    [sim3_ransac_iters, 3] float64 draw further."""
    _, _, tport, ref, _ = loaded
    lc = tport.loop_closer
    start = lc.generator.get_state()
    _, thinned = _thinned(ref, 0)
    try:
        assert lc._run_verify(thinned, 2, 0)[0].tolist()[0] < 20
        after_cut = lc.generator.get_state()
        lc.generator.set_state(start)
        assert lc._run_verify(tport.map, 2, 0)[0].tolist()[0] >= 20
        after_chain = lc.generator.get_state()
        lc.generator.set_state(start)
        torch.rand((CFG.solver.sim3_ransac_iters, 3), generator=lc.generator, dtype=torch.float64)
        assert torch.equal(after_cut, after_chain)
        assert torch.equal(after_cut, lc.generator.get_state())
    finally:
        lc.generator.set_state(start)


def test_correction_stages_match_reference(loaded):
    """The correction's device stages on the loaded map: the corrected
    neighbourhood and its fuse targets, the essential graph's edges, and
    the map after SearchAndFuse and the rebuilds."""
    _, _, tport, ref, _ = loaded
    kf, loop_kf = 2, 0
    S = sim3.compose(sim3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.01, 0.0], jnp.float32)),
                     sim3.from_se3(ref.map.kf_Tcw[kf]))
    old_j, vert_j, tg_j, ok_j = jlc._propagate_neighborhood(ref.map, jnp.int32(kf), *S,
                                                            covis_threshold=15, max_targets=24)
    St = tuple(t(x) for x in S)
    old_t, vert_t, tg_t, ok_t = tlc._propagate_neighborhood(tport.map, kf, *St,
                                                            covis_threshold=15, max_targets=24)
    np.testing.assert_allclose(old_t.numpy(), np.asarray(old_j), atol=1e-6)
    np.testing.assert_allclose(vert_t.numpy(), np.asarray(vert_j), atol=1e-5)
    np.testing.assert_array_equal(tg_t.numpy(), np.asarray(tg_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))

    edges_j = jlc.build_essential_edges(ref.map, essential_threshold=100, max_edges=512)
    edges_t = tlc.build_essential_edges(tport.map, essential_threshold=100, max_edges=512)
    for a, b in zip(edges_j, edges_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    assert int(edges_t[4]) >= 2

    pts_j, msk_j = jlc.gather_loop_points(ref.map, jnp.int32(loop_kf), covis_threshold=15)
    pts_t, msk_t = tlc.gather_loop_points(tport.map, loop_kf, covis_threshold=15)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(msk_t.numpy(), np.asarray(msk_j))
    bounds = (0.0, float(CFG.camera.width), 0.0, float(CFG.camera.height))
    jb = tuple(jnp.float32(b) for b in bounds)
    st_j, trunc_j = jlc._fuse_and_rebuild(ref.map, pts_j, msk_j, tg_j, ok_j, ref.builder.K,
                                          jnp.asarray(SF), jb, num_levels=NL)
    st_t = port_map(ref.map)
    trunc_t = tlc._fuse_and_rebuild(st_t, pts_t, msk_t, tg_t, ok_t, tport.builder.K, t(SF),
                                    bounds, num_levels=NL)
    assert int(trunc_t) == int(trunc_j)
    assert_maps_equal(st_t, st_j, atol=1e-6)


def test_relocalize_matches_reference(loaded):
    """`Tracker.relocalize` of frame 10 on the loaded map, LOST, with the
    reference's EPnP draw (its tracker key, split per attempt): the same
    candidate accepted, Tcw within 1e-4, the same bindings."""
    seq, _, tport, ref, _ = loaded
    img, depth = seq.frame(10)
    jframe = ref.builder.rgbd(jnp.asarray(img), jnp.asarray(depth), 10 / 30.0)
    frame = convert.frame_from_numpy(jframe._asdict(), "cpu")
    jt, tt = ref.tracker, tport.tracker
    jt.state, tt.state = JTrackState.LOST, TrackState.LOST
    key0 = jt._init_key
    assert jt.relocalize(jframe, ref.loop_closer.db)
    keys = [key0]

    def draw(mask):
        keys[0], sub = jax.random.split(keys[0])
        m = mask.numpy()
        p = jnp.asarray(m, jnp.float32) / max(int(m.sum()), 1)
        return t(jax.random.choice(sub, m.shape[0], shape=(CFG.solver.pnp_ransac_iters, 6),
                                   replace=True, p=p))

    tt.draw_pnp_samples = draw
    assert tt.relocalize(frame, tport.loop_closer.db)
    assert tt.state == TrackState.OK and tt.ref_kf == jt.ref_kf
    np.testing.assert_allclose(tt.last_Tcw.numpy(), np.asarray(jt.last_Tcw), atol=1e-4)
    np.testing.assert_array_equal(tt.last_point_idx.numpy(), np.asarray(jt.last_point_idx))
    err = np.linalg.norm((tt.last_Tcw.numpy() @ np.linalg.inv(seq.poses[10]))[:3, 3])
    assert err < 0.05, err


# -- TestCorrectLoopEndToEnd ----------------------------------------------


def _drifted_ring(rng, Kn=12, Npp=20, S=64):
    """`test_correct_loop_recovers_drifted_ring`'s map: a ring of
    keyframes with a random-walk drift, each sharing points with its ring
    neighbour only."""
    cam = CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5)
    cfg = SlamConfig(sensor=Sensor.RGBD, camera=cam,
                     orb=OrbConfig(num_features=S, feature_slots=S),
                     map=MapConfig(max_keyframes=16, max_points=1024))
    gt = np.stack([np.asarray(se3.exp_se3(jnp.asarray(
        [0.05 * np.cos(2 * np.pi * i / Kn), 0.05 * np.sin(2 * np.pi * i / Kn), 0, 0, 0,
         2 * np.pi * i / Kn], jnp.float32))) for i in range(Kn)]).astype(np.float32)
    est = gt.copy()
    err = np.eye(4)
    for i in range(1, Kn):
        err = err @ np.asarray(se3.exp_se3(jnp.asarray(rng.normal(0, 0.01, 6).astype(np.float32)))).astype(np.float64)
        est[i] = (err @ gt[i].astype(np.float64)).astype(np.float32)

    def project(T, pw):
        pc = (T[:3, :3] @ pw.T + T[:3, 3:4]).T
        return np.stack([480.0 * pc[:, 0] / pc[:, 2] + 319.5, 480.0 * pc[:, 1] / pc[:, 2] + 239.5], -1)

    st = jms.allocate(cfg.map, cfg.orb, obs_slots=8)
    pts_gt, pts_drift, descs, pid_of = [], [], [], []
    for i in range(Kn):
        Twc = np.linalg.inv(gt[i].astype(np.float64))
        pc = np.c_[rng.uniform(-1.0, 1.0, Npp), rng.uniform(-1.0, 1.0, Npp), rng.uniform(4.0, 7.0, Npp)]
        pw = (Twc[:3, :3] @ pc.T + Twc[:3, 3:4]).T
        pd = (np.linalg.inv(est[i].astype(np.float64)) @ np.r_[
            gt[i][:3, :3].astype(np.float64) @ pw.T + gt[i][:3, 3:4], np.ones((1, Npp))]).T[:, :3]
        pts_gt.append(pw.astype(np.float32))
        pts_drift.append(pd.astype(np.float32))
        descs.append(rng.integers(0, 2**32, (Npp, 8), dtype=np.uint32))
    for i in range(Kn):
        point_idx = jnp.full(S, -1, jnp.int32)
        xy = np.zeros((S, 2), np.float32)
        dsc = np.zeros((S, 8), np.uint32)
        if i > 0:
            point_idx = point_idx.at[jnp.arange(Npp)].set(pid_of[i - 1])
            xy[:Npp] = project(est[i], pts_drift[i - 1])
            dsc[:Npp] = descs[i - 1]
        xy[Npp:2 * Npp] = project(est[i], pts_drift[i])
        dsc[Npp:2 * Npp] = descs[i]
        st, k = jms.add_keyframe(st, jnp.int32(i), jnp.asarray(est[i]), jnp.asarray(xy),
                                 jnp.full(S, -1.0), jnp.full(S, -1.0), jnp.zeros(S, jnp.int32),
                                 jnp.zeros(S), jnp.asarray(dsc), jnp.arange(S) < 2 * Npp, point_idx)
        st, pids = jms.add_points(st, jnp.asarray(pts_drift[i]), jnp.ones(Npp, bool), k,
                                  jnp.arange(Npp, 2 * Npp, dtype=jnp.int32), jnp.asarray(descs[i]),
                                  jnp.zeros((Npp, 3)), jnp.zeros(Npp), jnp.ones(Npp) * 20.0,
                                  jnp.full(Npp, -1.0))
        pid_of.append(np.asarray(pids))
    return cfg, gt, est, st, pts_gt, pid_of


def test_correct_loop_recovers_drifted_ring(rng):
    """The whole CorrectLoop tail with a ground-truth S12, in both
    packages: poses within 1e-4 of the reference's, points within 1e-3 m,
    and the reference test's own bars on the port's result."""
    from orbslam2_tpu.geometry import camera as jcam

    cfg, gt, est, st, pts_gt, pid_of = _drifted_ring(rng)
    Kn = len(gt)
    K = jcam.Intrinsics.from_config(cfg.camera)
    S12 = sim3.from_se3(jnp.asarray(gt[Kn - 1] @ np.linalg.inv(gt[0])))
    port = port_map(st)
    ref = jlc.LoopCloser(cfg, K, codebook=jnp.zeros((4, 8), jnp.uint32)).correct_loop(
        st, Kn - 1, 0, S12, run_global_ba=False)
    tcfg = port_config(cfg)
    lc = tlc.LoopCloser(tcfg, convert.intrinsics_from_numpy(
        {k: np.asarray(v) for k, v in K._asdict().items()}, "cpu"),
        torch.zeros((4, 8), dtype=torch.int32), "cpu")
    out = lc.correct_loop(port, Kn - 1, 0, tuple(t(x) for x in S12), run_global_ba=False)
    assert out is port and lc.loops_closed == 1
    np.testing.assert_allclose(port.kf_Tcw.numpy(), np.asarray(ref.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(port.mp_pos.numpy(), np.asarray(ref.mp_pos), atol=1e-3)
    assert_maps_equal(port, ref, fields=["kf_point_idx", "mp_valid", "mp_obs_kf", "covis",
                                         "loop_edges"])

    def pose_err(T, i):
        return np.linalg.norm(np.asarray(se3.log_se3(jnp.asarray(
            (T @ np.linalg.inv(gt[i])).astype(np.float32)))))

    pre = np.asarray([pose_err(est[i], i) for i in range(Kn)])
    poses = port.kf_Tcw.numpy()[:Kn]
    post = np.asarray([pose_err(poses[i], i) for i in range(Kn)])
    assert post[Kn - 1] < 0.1 * pre[Kn - 1]
    assert post[Kn - 2] < 0.7 * pre[Kn - 2]
    assert np.sqrt((post ** 2).mean()) < np.sqrt((pre ** 2).mean())
    for i in range(Kn):
        d = np.linalg.norm(port.mp_pos.numpy()[pid_of[i]] - pts_gt[i], axis=-1).max()
        assert d < 8.0 * post[i] + 0.02, (i, d, post[i])
