"""The reference package's keyframe decisions on the 640x480 orbit
(bench.py's segment B), with their inputs, and every frame's pose as it
was tracked, before any later correction; and a comparison of such a
record with the port's.

    JAX_PLATFORMS=cpu python tools/orbit_reference_decisions.py record OUT.json
    python tools/orbit_reference_decisions.py compare REF.json PORT.json [FROM]

`record` runs the reference on the CPU, in one process with one JAX
device and `pipeline_depth=0`, as `tools/loop_reference_targets.py orbit640`
does (about nine minutes on three cores). It writes the layout that
`chip_smoke.run_orbit_session` records for the port and
`tools/loop_port_sessions.py orbit640 cuda|cpu OUT.json` writes:
`decisions`, one (frame, inliers, the reference keyframe's tracked points,
close tracked, close free, frames since the last keyframe, keyframes,
made) for every steady-state frame; `tracked_poses`, each frame's Tcw as
`track_rgbd` returned it; `keyframe_frames`, `loop_frames`, `lost_frames`.

`compare` prints, from frame FROM (70 by default) on, the frames where
the two sessions' keyframe decisions differ, and for each session every
frame's camera-centre error to the ground truth before any correction
(both trajectories in the first camera's frame, no alignment), with the
stretches of consecutive keyframes (keyframes at two frames in three or
denser) and the first frame whose error passes 0.05, 0.1, 0.25 and 0.5 m.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_ORBIT, N_REVISIT = 170, 35
BARS_M = (0.05, 0.1, 0.25, 0.5)


def record(out_path: str) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.pipeline import fused
    from orbslam2_tpu.pipeline.system import System
    from tools.loop_reference_targets import BENCH, _loop_frames

    cfg = dataclasses.replace(BENCH, tracking=dataclasses.replace(BENCH.tracking, th_depth=130.0))
    seq = synthetic.textured_sequence(n_frames=N_ORBIT, kind="orbit", cam=cfg.camera)
    seq = dataclasses.replace(seq, poses=np.concatenate([seq.poses, seq.poses[:N_REVISIT]]))
    slam = System(cfg)
    decisions, frame_no = [], [0]
    step_fn = fused.frame_and_keyframe_step

    def recorded_step(*args, **kw):
        t = slam.tracker
        since, n_kfs = t.frames_since_kf, t.n_keyframes
        state, frame, res = step_fn(*args, **kw)
        tr = res.track
        counts = [int(x) for x in jax.device_get((tr.ref_tracked, tr.close_tracked,
                                                   tr.close_free))]
        decisions.append([frame_no[0], int(tr.n_inliers), *counts, since, n_kfs,
                          bool(res.is_kf)])
        return state, frame, res

    fused.frame_and_keyframe_step = recorded_step
    try:
        for i in range(N_ORBIT + N_REVISIT):
            frame_no[0] = i
            img, depth = seq.frame(i)
            slam.track_rgbd(img, depth, timestamp=i / 30.0)
        slam.flush()
    finally:
        fused.frame_and_keyframe_step = step_fn
    _, _, tracked = slam.frame_poses()
    out = dict(session="orbit640", device="reference, cpu", devices=len(jax.devices()),
               decisions=decisions,
               tracked_poses=[np.asarray(r.Tcw, np.float64).tolist() for r in slam.results],
               keyframe_frames=[i for i, r in enumerate(slam.results) if r.is_keyframe],
               loop_frames=_loop_frames(slam), lost_frames=np.nonzero(~tracked)[0].tolist(),
               gt_poses=seq.poses.tolist())
    with open(out_path, "w") as f:
        json.dump(out, f)
    print(json.dumps({k: out[k] for k in ("session", "devices", "keyframe_frames",
                                          "loop_frames", "lost_frames")}), flush=True)


def centre_errors(tracked_poses, gt_poses) -> np.ndarray:
    """Per frame, the distance between the tracked and the true camera
    centres, the truth carried into the first camera's frame (where the
    session puts its origin)."""
    est = np.asarray(tracked_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64) @ np.linalg.inv(np.asarray(gt_poses[0], np.float64))
    c_est = -np.einsum("nji,nj->ni", est[:, :3, :3], est[:, :3, 3])
    c_gt = -np.einsum("nji,nj->ni", gt[:, :3, :3], gt[:, :3, 3])
    return np.linalg.norm(c_est - c_gt, axis=1)


def dense_stretches(kf_frames, span: int = 3, need: int = 2, min_len: int = 4) -> list:
    """Runs of frames where every window of `span` frames holds at least
    `need` keyframes, at least `min_len` keyframes long: (first, last)."""
    kfs = sorted(kf_frames)
    runs, start = [], None
    for a, b in zip(kfs, kfs[1:]):
        close = b - a <= span - need + 1
        if close and start is None:
            start = a
        if not close and start is not None:
            runs.append((start, a))
            start = None
    if start is not None:
        runs.append((start, kfs[-1]))
    return [r for r in runs if sum(r[0] <= k <= r[1] for k in kfs) >= min_len]


def compare(ref_path: str, port_path: str, first: int = 70) -> None:
    with open(ref_path) as f:
        ref = json.load(f)
    with open(port_path) as f:
        port = json.load(f)
    gt = ref["gt_poses"]
    rd = {d[0]: d for d in ref["decisions"]}
    pd = {d[0]: d for d in port["decisions"]}
    parted = [f for f in sorted(set(rd) & set(pd)) if f >= first and rd[f][-1] != pd[f][-1]]
    print(f"decisions from frame {first}: reference keyframes "
          f"{[f for f in ref['keyframe_frames'] if f >= first]}", flush=True)
    print(f"decisions from frame {first}: {port.get('device', 'port')} keyframes "
          f"{[f for f in port['keyframe_frames'] if f >= first]}", flush=True)
    print(f"frames whose decision differs: {parted}", flush=True)
    for name, rec in (("reference", ref), (port.get("device", "port"), port)):
        err = centre_errors(rec["tracked_poses"], gt)
        firsts = {bar: next((i for i, e in enumerate(err) if e > bar), None) for bar in BARS_M}
        print(f"{name}: keyframe stretches {dense_stretches(rec['keyframe_frames'])}; error "
              f"at frames 69/99/123/150/169 "
              f"{[round(float(err[i]), 4) for i in (69, 99, 123, 150, 169)]} m; first frame "
              f"past {firsts}; loops {rec['loop_frames']}, lost {rec['lost_frames']}",
              flush=True)
        print(f"{name}: error per frame from {first}: "
              f"{[round(float(e), 4) for e in err[first:N_ORBIT]]}", flush=True)


def main():
    if sys.argv[1] == "record":
        record(sys.argv[2])
    elif sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3], int(sys.argv[4]) if len(sys.argv) > 4 else 70)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
