"""The pipelined session (`pipeline_depth` N >= 1: each frame resolved N
frames after its dispatch) and `defer_local_ba`, the port against the
reference package on the same frames:

* the mapping slice's 18-frame 320x240 dolly at depth 2: the reference's
  keyframes and keyframe records, the FIFO as deep as the reference's
  after every frame, every frame tracked, poses within 5 mm and 0.2
  degrees;
* marked slow: depth 1 and 2 against depth 0 in the port on
  `tests/test_e2e_rgbd.py::test_rgbd_pipelined_matches_sync`'s session
  (that test's bars); `defer_local_ba` at depth 1 against the reference;
  the blackout session at depth 2 (three black frames, two of them in
  flight when the first is resolved LOST) and a one-frame gap whose LOST
  resolve folds in a keyframe inserted behind it, each against the
  reference's run of it; and the 320x240 orbit at depth 2, whose loop correction and global
  BA fold-in land at resolves with frames in flight, against the
  reference's run.

The reference's loop-closing sessions run in a child process with one JAX
device (`tools/loop_reference_targets.py`), as in
`tests/test_torch_loop_slice.py`.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from orbslam2_tpu.io import synthetic
from orbslam2_tpu.pipeline.system import System as JSystem
from orbslam2_tpu.utils.evaluation import ate_rmse
from orbslam2_tpu_torch.pipeline.system import System as TSystem
from orbslam2_tpu_torch.pipeline.tracking import TrackState
from tests.test_torch_mapping_slice import CFG, N_FRAMES, _kf_frames, small_cfg
from tests.torch_config import port_config
from tests.torch_threads import share_cores

share_cores()

DT_M, DEG = 5e-3, 0.2


def at_depth(cfg, depth: int, **tracking):
    return dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking, pipeline_depth=depth, **tracking))


def run_depth(slam, seq, n):
    """Track `n` frames of `seq`; returns the FIFO's length after each
    frame and the session's (timestamps, poses, tracked)."""
    in_flight = []
    for i in range(n):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
        in_flight.append(len(slam._pending))
    return in_flight, slam.frame_poses()


def pose_gaps(pa, pb):
    dt = np.linalg.norm(pa[:, :3, 3] - pb[:, :3, 3], axis=1)
    R = np.einsum("nji,njk->nik", pa[:, :3, :3], pb[:, :3, :3])
    deg = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    return dt, deg


@pytest.fixture(scope="module")
def depth2():
    seq = synthetic.textured_sequence(n_frames=N_FRAMES, kind="forward", cam=CFG.camera)
    cfg = at_depth(CFG, 2)
    ref = JSystem(cfg, enable_mapping=True, enable_loop_closing=False)
    port = TSystem(port_config(cfg), device="cpu", enable_mapping=True, enable_loop_closing=False)
    return ref, run_depth(ref, seq, N_FRAMES), port, run_depth(port, seq, N_FRAMES)


def test_depth2_keyframes_match_reference(depth2):
    """The reference's keyframe frames (those of depth 0), its keyframe
    records, and its FIFO: empty after the initializing frame, then two
    frames in flight after every later one."""
    ref, (fifo_ref, _), port, (fifo_port, _) = depth2
    assert _kf_frames(port) == _kf_frames(ref) == [0, 6, 17]
    assert port.log.of("keyframe") == ref.log.of("keyframe")
    assert fifo_port == fifo_ref == [0, 1] + [2] * (N_FRAMES - 2)
    assert port._pending == [] and len(port.results) == N_FRAMES


def test_depth2_poses_match_reference(depth2):
    """Every frame tracked, poses within 5 mm and 0.2 degrees."""
    _, (_, (_, pj, tj)), port, (_, (_, pt, tt)) = depth2
    assert tj.all() and tt.all()
    assert port.get_tracking_state() == TrackState.OK
    dt, deg = pose_gaps(pj, pt)
    assert dt.max() < DT_M and deg.max() < DEG, (dt.max(), deg.max())


@pytest.mark.slow
def test_depths_match_synchronous_session():
    """`test_rgbd_pipelined_matches_sync` on the port: depth 1 and 2 make
    as many keyframes as depth 0, track every frame, and their ATE lies
    within 5e-3 m of depth 0's."""
    cfg = small_cfg()
    seq = synthetic.textured_sequence(n_frames=24, kind="forward", cam=cfg.camera)
    out = {}
    for depth in (0, 1, 2):
        slam = TSystem(port_config(at_depth(cfg, depth)), device="cpu", enable_loop_closing=False)
        _, (_, poses, tracked) = run_depth(slam, seq, len(seq))
        assert tracked.all() and len(poses) == len(seq), depth
        out[depth] = (slam.num_keyframes(), ate_rmse(poses, seq.poses, align=True))
    kf0, ate0 = out[0]
    assert ate0 < 0.03
    for depth in (1, 2):
        kf, ate = out[depth]
        assert ate < 0.03 and kf == kf0 and abs(ate - ate0) < 5e-3, (depth, out)


@pytest.mark.slow
def test_deferred_local_ba_matches_reference():
    """`defer_local_ba` at depth 1: each keyframe's step skips local BA,
    which runs at the keyframe's resolve, one frame later. The port runs
    it where the reference does: the same keyframes, BA runs and poses
    within 5 mm and 0.2 degrees."""
    from orbslam2_tpu_torch.pipeline import fused

    seq = synthetic.textured_sequence(n_frames=N_FRAMES, kind="forward", cam=CFG.camera)
    cfg = at_depth(CFG, 1, defer_local_ba=True)
    ref = JSystem(cfg, enable_mapping=True, enable_loop_closing=False)
    _, (_, pj, tj) = run_depth(ref, seq, N_FRAMES)
    deferred, real = [], fused.deferred_local_ba

    def counted(state, kf_id, *args, **kw):
        deferred.append(kf_id)
        return real(state, kf_id, *args, **kw)

    fused.deferred_local_ba = counted
    try:
        port = TSystem(port_config(cfg), device="cpu", enable_mapping=True,
                       enable_loop_closing=False)
        _, (_, pt, tt) = run_depth(port, seq, N_FRAMES)
    finally:
        fused.deferred_local_ba = real
    assert _kf_frames(port) == _kf_frames(ref)
    assert port.log.of("keyframe") == ref.log.of("keyframe")
    # every keyframe made by the frame step: all but the initializing one
    assert deferred == [e["kf_id"] for e in port.log.of("keyframe")][1:]
    assert tj.all() and tt.all()
    dt, deg = pose_gaps(pj, pt)
    assert dt.max() < DT_M and deg.max() < DEG, (dt.max(), deg.max())


def reference_session(name: str, depth: int) -> dict:
    """The reference's session `name` of `tools/loop_reference_targets.py`
    at `depth`, run on the CPU in a child process with one JAX device."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                                if "xla_force_host_platform_device_count" not in f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, os.path.join(root, "tools", "loop_reference_targets.py"),
                          "--depth", str(depth), name], env=env, cwd=root, capture_output=True,
                         text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["session"] == name and res["devices"] == 1 and res["pipeline_depth"] == depth
    return res


@pytest.mark.slow
def test_lost_at_depth2_matches_reference():
    """The blackout session (34 dolly frames, 3 black frames, then frame
    10 until it relocalizes) at depth 2: the first black frame is resolved
    LOST with the next two in flight, which are then reprocessed on the
    exact path. The reference's per-frame states, orphaned keyframes and
    relocalization try, within 1e-4 m of its translation error."""
    cfg = at_depth(small_cfg(), 2)
    ref = reference_session("reloc_small", 2)
    seq = synthetic.textured_sequence(n_frames=34, kind="forward", cam=cfg.camera)
    slam = TSystem(port_config(cfg), device="cpu")
    reprocessed, real = [], TSystem._reprocess_stale

    def counted(self, extra=None):
        reprocessed.append(len(self._pending) + (extra is not None))
        return real(self, extra)

    TSystem._reprocess_stale = counted
    try:
        in_flight, _ = run_depth(slam, seq, 34)
        ok_before = slam.get_tracking_state() == TrackState.OK
        n_kf = slam.num_keyframes()
        black = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
        for j in range(3):
            slam.track_rgbd(black, black, timestamp=(34 + j) / 30.0)
        lost = slam.get_tracking_state() == TrackState.LOST
        img, depth = seq.frame(10)
        tries = None
        for j in range(3):
            slam.track_rgbd(img, depth, timestamp=(37 + j) / 30.0)
            if slam.get_tracking_state() == TrackState.OK:
                tries = j
                break
    finally:
        TSystem._reprocess_stale = real
    assert in_flight[-1] == 2 and reprocessed == [2]
    assert ok_before and lost and n_kf == ref["keyframes"]
    assert [r.state.name for r in slam.results] == ref["states"]
    assert [e["kf_id"] for e in slam.log.of("keyframe") if e.get("orphaned")] == ref["orphaned"]
    assert tries == ref["relocalized_at_try"] is not None
    err = float(np.linalg.norm((slam.results[-1].Tcw @ np.linalg.inv(seq.poses[10]))[:3, 3]))
    assert abs(err - ref["t_err"]) < 1e-4, (err, ref["t_err"])


@pytest.mark.slow
def test_orphaned_keyframe_matches_reference():
    """60 frames of the mapping slice's dolly at depth 2 with frame 54
    black, after 6 keyframes (so no auto-reset): frame 55's dispatch,
    chained off the black frame, inserts a keyframe before frame 54 is
    resolved LOST. That resolve folds the keyframe into the host
    bookkeeping as orphaned, then reprocesses frames 55 and 56 on the
    exact path, where they relocalize. The reference's per-frame states,
    keyframe records (the orphaned one among them), relocalization and
    tracked frames, their poses within 5 mm and 0.2 degrees."""
    cfg = at_depth(CFG, 2)
    ref = reference_session("gap320", 2)
    n = ref["frames"]
    seq = synthetic.textured_sequence(n_frames=n, kind="forward", cam=cfg.camera)
    black = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    slam = TSystem(port_config(cfg), device="cpu")
    for i in range(n):
        img, depth = (black, black) if i == ref["black_at"] else seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    _, poses, tracked = slam.frame_poses()
    events = [[e["kf_id"], e["frame_id"], bool(e.get("orphaned"))]
              for e in slam.log.of("keyframe")]
    assert [r.state.name for r in slam.results] == ref["states"]
    assert events == ref["keyframe_events"] and [e for e in events if e[2]], events
    assert [e["frame_id"] for e in slam.log.of("relocalized")] == ref["relocalized"]
    assert len(slam.log.of("reset")) == ref["resets"] == 0
    assert tracked.tolist() == ref["tracked"]
    dt, deg = pose_gaps(np.asarray(ref["poses"])[tracked], poses[tracked])
    assert dt.max() < DT_M and deg.max() < DEG, (dt.max(), deg.max())


@pytest.mark.slow
def test_loop_absorbed_at_depth2_matches_reference():
    """The 320x240 orbit and its revisit at depth 2, the cheapest session
    in which a loop correction (and later the global BA's fold-in) lands
    at a resolve while frames are in flight: those are resolved against
    the reference poses they were dispatched with and tracking re-anchors
    (`_absorb_pending`). The reference's loops at its frames, no more
    frames lost, the orbit's frames within 5 cm."""
    from tests.test_torch_loop_slice import _loop_frames, _orbit_cfg, _orbit_seq

    ref = reference_session("orbit320", 2)
    cfg = at_depth(_orbit_cfg(), 2)
    seq = _orbit_seq(cfg)
    absorbed, real = [], TSystem._absorb_pending

    def counted(self, extra=None):
        absorbed.append(len(self._pending) + (extra is not None))
        return real(self, extra)

    TSystem._absorb_pending = counted
    try:
        slam = TSystem(port_config(cfg), device="cpu")
        _, (_, poses, tracked) = run_depth(slam, seq, len(seq))
    finally:
        TSystem._absorb_pending = real
    assert ref["loops_closed"] >= 1
    assert slam.loop_closer.loops_closed == ref["loops_closed"]
    assert _loop_frames(slam) == ref["loop_frames"]
    assert max(absorbed) == 2, absorbed
    assert int((~tracked).sum()) <= ref["lost"]
    assert ate_rmse(poses[:170], seq.poses[:170], align=True) < 0.05
