"""What the long session leans on, at a small size, the port against the
reference on the same inputs:

* slot recycling in a live session: the first 28 frames of
  `test_orbit_loop_closes`'s 320x240 orbit with loop closing on and a
  pool of 7 keyframe slots. Keyframes come at frames 0, 2, 5, 9, 13, 17,
  22 and 27; the 7th fills the pool, so slot 1 (frame 2's keyframe) is
  culled at frame 22 and recycled by frame 27's, which culls slot 2. (A
  pool of 4 or 5 slots on the 18-frame dolly never recycles: it makes 3
  keyframes, and the cull spares slot 0 and the 5 newest.)
* the scale stress's chain (`orbslam2_tpu_torch.scale`, `stress_scale.py`)
  at 64 keyframes and 4096 points on the same arrays: the observation
  tables, covisibility, essential edges, 3 PCG pose-graph iterations and
  the global BA's first 2 iterations.

The reference's `LocalMapper._pressure_cull` writes into
`np.asarray(kf_cull_pressure_scores(state))`, which with this JAX on the
CPU is a read-only view, and raises. The session here gives it a
writable copy of the same scores (ROADMAP, queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import MapConfig, OrbConfig
from orbslam2_tpu.geometry.camera import Intrinsics as JIntrinsics
from orbslam2_tpu.io import synthetic
from orbslam2_tpu.pipeline import local_mapping as jlm
from orbslam2_tpu.pipeline import loop_closing as jlc
from orbslam2_tpu.pipeline.system import System as JSystem
from orbslam2_tpu.slam_map import map_state as jms
from orbslam2_tpu.solvers import ba as jba
from orbslam2_tpu.solvers import pose_graph as jpg
from orbslam2_tpu_torch import scale
from orbslam2_tpu_torch.geometry.camera import Intrinsics as TIntrinsics
from orbslam2_tpu_torch.pipeline import local_mapping as tlm
from orbslam2_tpu_torch.solvers import ba as tba
from orbslam2_tpu_torch.pipeline.system import System as TSystem
from tests.test_torch_loop_slice import _orbit_cfg
from tests.test_torch_loop_solvers import assert_packs_close
from tests.test_torch_mapping_slice import _kf_frames, _run
from tests.torch_config import port_config
from tests.torch_threads import share_cores

share_cores()

RECYCLE_SLOTS, RECYCLE_FRAMES = 7, 28
SCALE_K, SCALE_P = 64, 4096


def _recycle_cfg():
    cfg = _orbit_cfg()
    return dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, max_keyframes=RECYCLE_SLOTS))


@pytest.fixture(scope="module")
def recycled():
    """Both packages' sessions, with the slots each culled, in order."""
    cfg = _recycle_cfg()
    seq = synthetic.textured_sequence(n_frames=170, kind="orbit", cam=cfg.camera)
    culled = {"ref": [], "port": []}
    ref_cull, port_cull = jlm.LocalMapper._cull, tlm.LocalMapper._cull
    scores = jlm.kf_cull_pressure_scores
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlm.LocalMapper, "_cull",
                   lambda self, st, c: culled["ref"].append(c) or ref_cull(self, st, c))
        mp.setattr(tlm.LocalMapper, "_cull",
                   lambda self, st, c: culled["port"].append(c) or port_cull(self, st, c))
        mp.setattr(jlm, "kf_cull_pressure_scores", lambda st: np.array(scores(st)))
        ref = JSystem(cfg)
        port = TSystem(port_config(cfg), device="cpu")
        return dict(ref=ref, ref_run=_run(ref, seq, RECYCLE_FRAMES), port=port,
                    port_run=_run(port, seq, RECYCLE_FRAMES), culled=culled)


def test_recycling_matches_reference(recycled):
    """The reference's keyframes, culled slots in its order (frame 27's
    keyframe recycles slot 1), more keyframes inserted than slots, the
    same database rows after recycling, and every frame's pose within
    5 mm and 0.2 degrees."""
    ref, port = recycled["ref"], recycled["port"]
    assert _kf_frames(port) == _kf_frames(ref) == [0, 2, 5, 9, 13, 17, 22, 27]
    assert recycled["culled"]["port"] == recycled["culled"]["ref"] == [1, 2]
    assert int(port.map.num_kf) == int(ref.map.num_kf) == 8 > RECYCLE_SLOTS
    assert int(port.map.kf_frame_id[1]) == int(ref.map.kf_frame_id[1]) == 27
    jdb, tdb = ref.loop_closer.db, port.loop_closer.db
    np.testing.assert_array_equal(tdb.present.numpy(), np.asarray(jdb.present))
    np.testing.assert_allclose(tdb.vectors.numpy(), np.asarray(jdb.vectors), atol=1e-6)
    (_, pj, tj), (_, pt, tt) = recycled["ref_run"], recycled["port_run"]
    assert tj.all() and tt.all()
    dt = np.linalg.norm(pj[:, :3, 3] - pt[:, :3, 3], axis=1)
    R = np.einsum("nji,njk->nik", pj[:, :3, :3], pt[:, :3, :3])
    deg = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert dt.max() < 5e-3 and deg.max() < 0.2, (dt.max(), deg.max())


def _reference_scale_state(a, K, P, S, O):
    """`stress_scale.py:50-105`'s state from the same arrays."""
    state = jms.allocate(MapConfig(max_keyframes=K, max_points=P + 1024),
                         OrbConfig(feature_slots=S), obs_slots=O)
    return state._replace(
        kf_Tcw=jnp.asarray(a["kf_Tcw"]), kf_valid=jnp.ones(K, bool),
        kf_frame_id=jnp.arange(K, dtype=jnp.int32), kf_xy=jnp.asarray(a["kf_xy"]),
        kf_ur=jnp.asarray(a["kf_ur"]), kf_depth=jnp.asarray(a["kf_depth"]),
        kf_feat_valid=jnp.ones((K, S), bool), kf_point_idx=jnp.asarray(a["kf_point_idx"]),
        kf_parent=jnp.asarray(a["kf_parent"]),
        mp_pos=state.mp_pos.at[:P].set(jnp.asarray(a["mp_pos"])),
        mp_valid=state.mp_valid.at[:P].set(True),
        mp_ref_kf=state.mp_ref_kf.at[:P].set(jnp.asarray(a["mp_ref_kf"])),
        mp_first_kf=state.mp_first_kf.at[:P].set(jnp.asarray(a["mp_ref_kf"])),
        num_kf=jnp.int32(K), num_mp=jnp.int32(P))


def test_scale_chain_matches_reference():
    """`scale.run_stages` at K=64, P=4096 against the reference's
    functions of the same names on the same arrays: the observation tables
    and covisibility equal, the edge count and edges equal, the pose-graph
    vertices within 1e-4 up to each quaternion's sign. The global BA's
    cost: equal before the iterations, within 1e-4 relative after one;
    after two the float32 packages part by more (the steps of this
    ill-conditioned problem depend on float32 rounding: the reference and
    the port lie 1.65e-3 relative apart, each 5e-3 to 7e-3 above the
    port's float64 run), so there the port is held closer to the reference
    than the reference is to the float64 run, and below its start."""
    K, P, S, O = SCALE_K, SCALE_P, scale.SLOTS, scale.OBS
    a = scale.build_arrays(K, P, S, O, scale.SEED)
    st = scale.build_state(K, P, S, O, scale.SEED, "cpu")
    got = scale.run_stages(st, torch.device("cpu"))

    js = _reference_scale_state(a, K, P, S, O)
    js, truncated = jms.rebuild_observations(js)
    js = jlc.rebuild_covisibility(js)
    for f in ("mp_obs_kf", "mp_obs_feat", "mp_n_obs", "covis"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    assert got["obs_truncated"] == int(truncated)
    ei, ej, meas, evalid, n_total = jlc.build_essential_edges(js, essential_threshold=100,
                                                              max_edges=4 * K)
    assert got["edges_total"] == int(n_total) > K - 1
    for g, r in zip(got["edges"][:2] + got["edges"][3:], (ei, ej, evalid)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    prob = jpg.PoseGraphProblem(
        vertices=jax.vmap(jpg.se3_to_pack)(js.kf_Tcw), vertex_valid=js.kf_valid,
        vertex_fixed=jnp.zeros(K, bool).at[0].set(True), edge_i=ei, edge_j=ej, edge_meas=meas,
        edge_valid=evalid, edge_weight=jnp.where(evalid, 1.0, 0.0))
    assert_packs_close(got["packs"], jpg.optimize_pose_graph_pcg(prob, iters=3, cg_iters=64),
                       atol=1e-4)

    gprob, *_ = jlm.build_global_ba_problem(js, jnp.ones(8, jnp.float32), max_points=P + 1024,
                                            obs_slots=O)
    ref = [float(jba.bundle_adjust(gprob, JIntrinsics.from_config(scale.CAMERA), iters=i,
                                   use_kernel=True).cost) for i in (0, 1, 2)]
    tprob, *_ = tlm.build_global_ba_problem(st, torch.ones(8), max_points=P + 1024, obs_slots=O)
    one = float(tba.bundle_adjust(tprob, TIntrinsics.from_config(scale.CAMERA, "cpu"), iters=1,
                                  use_kernel=True).cost)
    f64 = tba.BAProblem(*(x.double() if x.is_floating_point() else x for x in tprob))
    exact = float(tba.bundle_adjust(f64, TIntrinsics.from_config(scale.CAMERA, "cpu",
                                                                 dtype=torch.float64),
                                    iters=2, use_kernel=True).cost)
    np.testing.assert_allclose(got["gba_cost_start"], ref[0], rtol=1e-6)
    np.testing.assert_allclose(one, ref[1], rtol=1e-4)
    assert got["gba_cost"] < got["gba_cost_start"]
    assert abs(got["gba_cost"] - ref[2]) < abs(ref[2] - exact), (got["gba_cost"], ref[2], exact)
