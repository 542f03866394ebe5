"""The port's localization mode against the plain reference of the
localization step (`slambench/reference_localize.py`), frame by frame, on a
benchmark cell's own frames.

    python tools/localize_parity.py [--workload tum3-rgbd-localize.fr3-localize]
        [--seed N] [--frames 600] [--control-frames 40] [--out FILE.json]

On the card: the cell's `Frames` and `Driver` (`slambench.run`) map the
mix's set-up frames in SLAM mode, localization mode is switched on, and
`--frames` window frames go through the normal path with the program's
tracer on. Meanwhile `Capture` keeps what each frame started from (the
frame's features, the previous frame's state, as the port handed them to
its step) and what the port returned. Then:

* the map's structure is compared bit for bit before and after the window:
  every field of the map but the visibility counters (`mp_visible`,
  `mp_found`), which ORB-SLAM2 also updates in this mode;
* every window frame is fed to the reference from the port's own inputs,
  so errors do not compound, and compared: the decision (map / VO /
  LOST), the pose and the inlier count. A frame on which relocalization
  won ends its comparison there (the reference does not relocalize);
* the control: the reference with its pose optimisation in bfloat16 on
  the first `--control-frames` frames, which must fail the pose tolerance.

Tolerances, each with its reason:

* the same decision on every frame, and the same next reference
  keyframe: the
  reference makes the port's choices from the same inputs;
* camera centre within 1e-4 m and rotation within 0.01 degrees: K2 and the
  reference's float32 Gauss-Newton sum in different orders (3.4e-7 apart
  at the same inputs), and a pose's few extra or fewer inliers at a chi2
  or radius boundary move it by ~1e-5 m;
* inlier counts equal on at least 99 % of the frames and within 2 on the
  rest: a feature on a gate's boundary may fall either way in another
  summation order.

Prints one JSON line; the per-frame rows go to `--out`. Runs on the CPU
too (`--device cpu`), slowly at the cell's size.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slambench import reference_localize as ref  # noqa: E402

DT_M, DROT_DEG = 1e-4, 0.01
INLIER_SHARE, INLIER_SLACK = 0.99, 2
# every field of the map but the visibility counters
EXEMPT = ("mp_visible", "mp_found")


def map_snapshot(m) -> dict:
    """Copies of every map field that localization mode must not write."""
    import dataclasses

    return {f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)
            if f.name not in EXEMPT}


def map_changes(before: dict, m) -> list[str]:
    """The fields whose bits differ from `before`."""
    return [k for k, v in before.items() if not torch.equal(v, getattr(m, k))]


class Capture:
    """While installed, records every localization-mode frame of any
    session: for a frame on the fused step, its features and the anchors
    the port handed to `fused.frame_and_keyframe_step`, and the step's
    decision, pose and inliers; for a frame on the odometry path
    (`Tracker.localization_vo_step`), its features, the last frame, pose
    and motion model it started from, whether relocalization won, and the
    result. Nothing the port computes is changed."""

    def __init__(self):
        self.records: list[dict] = []
        self._restore: list = []

    def install(self) -> None:
        from orbslam2_tpu_torch.pipeline import fused
        from orbslam2_tpu_torch.pipeline.tracking import Tracker

        cap = self
        step = fused.frame_and_keyframe_step
        sig = inspect.signature(step)

        def stepped(*args, **kwargs):
            a = sig.bind(*args, **kwargs).arguments
            frame, res = step(*args, **kwargs)
            if not a["mapping_enabled"]:
                decision = "map" if res.accept else ("VO" if res.ok else "LOST")
                cap.records.append(dict(
                    kind="step", frame=frame, decision=decision, pose=np.array(res.pose),
                    n_inliers=int(res.n_inliers), local_ref=int(res.local_ref),
                    prev=ref.Previous(
                        frame=SimpleNamespace(xy=a["last_xy"], octave=a["last_octave"],
                                              angle=a["last_angle"], desc=a["last_desc"]),
                        point_idx=a["last_point_idx"], Tcw=a["last_Tcw"].clone(),
                        velocity=a["velocity"].clone(), has_velocity=bool(a["has_velocity"]),
                        ref_kf=int(a["ref_kf"]))))
            return frame, res

        vo_step = Tracker.localization_vo_step
        reloc = Tracker.relocalize

        def vo_stepped(tracker, frame, db):
            rec = dict(kind="vo", frame=frame, last=tracker.last_frame,
                       last_Tcw=tracker.last_Tcw.clone(),
                       velocity=None if tracker.velocity is None else tracker.velocity.clone(),
                       reloc_won=False)
            cap._vo = rec
            try:
                out = vo_step(tracker, frame, db)
            finally:
                cap._vo = None
            rec.update(decision="reloc" if rec["reloc_won"] else
                       ("VO" if out.state.name == "OK" else "LOST"),
                       pose=np.array(out.Tcw), n_inliers=int(out.num_inliers))
            cap.records.append(rec)
            return out

        def relocalized(tracker, frame, db):
            won = reloc(tracker, frame, db)
            if getattr(cap, "_vo", None) is not None:
                cap._vo["reloc_won"] = bool(won)
            return won

        self._rebind(fused, "frame_and_keyframe_step", stepped)
        self._rebind(Tracker, "localization_vo_step", vo_stepped)
        self._rebind(Tracker, "relocalize", relocalized)

    def _rebind(self, owner, attr, new):
        self._restore.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def uninstall(self) -> None:
        while self._restore:
            owner, attr, old = self._restore.pop()
            setattr(owner, attr, old)


def reference_outcome(rec: dict, m, s: ref.Settings, precision=torch.float32):
    """The reference's outcome of one captured frame; None for a frame on
    which relocalization won."""
    if rec["kind"] == "step":
        return ref.track_frame(m, rec["frame"], rec["prev"], s, precision=precision)
    if rec["reloc_won"]:
        return None
    return ref.odometry_frame(rec["frame"], rec["last"], rec["last_Tcw"], rec["velocity"], s,
                              precision=precision)


def compare(records: list, m, s: ref.Settings, precision=torch.float32) -> list[dict]:
    """One row a captured frame: its kind, both decisions, the pose gaps
    and both inlier counts."""
    rows = []
    for k, rec in enumerate(records):
        out = reference_outcome(rec, m, s, precision)
        row = dict(i=k, kind=rec["kind"], port=rec["decision"], n_port=rec["n_inliers"])
        if out is None:
            row.update(ref="reloc", n_ref=None, dt_m=None, drot_deg=None)
        else:
            dt, drot = ref.pose_gap(torch.as_tensor(rec["pose"]), out.Tcw)
            row.update(ref=out.decision, n_ref=out.n_inliers, dt_m=dt, drot_deg=drot)
        if rec["kind"] == "step":
            row.update(kf_port=rec["local_ref"], kf_ref=out.local_ref)
        rows.append(row)
    return rows


def verdict(rows: list) -> dict:
    """The tolerances over the compared rows (relocalized frames left out)."""
    cmp = [r for r in rows if r["ref"] != "reloc"]
    same = [r["port"] == r["ref"] and r.get("kf_port") == r.get("kf_ref") for r in cmp]
    finite = [r for r in cmp if np.isfinite(r["dt_m"]) and np.isfinite(r["drot_deg"])]
    dn = [abs(r["n_port"] - r["n_ref"]) for r in cmp]
    out = dict(
        frames=len(rows), compared=len(cmp), relocalized=len(rows) - len(cmp),
        decisions_equal=int(sum(same)),
        decisions_port={d: sum(r["port"] == d for r in rows) for d in ("map", "VO", "LOST",
                                                                       "reloc")},
        dt_max_m=max((r["dt_m"] for r in finite), default=0.0),
        drot_max_deg=max((r["drot_deg"] for r in finite), default=0.0),
        non_finite=len(cmp) - len(finite),
        inliers_equal_share=(sum(d == 0 for d in dn) / len(dn)) if dn else 1.0,
        inliers_max_gap=max(dn, default=0))
    out["poses_ok"] = (out["dt_max_m"] <= DT_M and out["drot_max_deg"] <= DROT_DEG
                       and out["non_finite"] == 0)
    out["ok"] = (out["decisions_equal"] == len(cmp) and out["poses_ok"]
                 and out["inliers_equal_share"] >= INLIER_SHARE
                 and out["inliers_max_gap"] <= INLIER_SLACK)
    return out


# degrees of yaw from the last mapped pose of `yaw_session`: away from the
# map in even steps until the odometry takes over, then back until
# relocalization re-anchors
YAWS = list(range(5, 75, 5)) + [60, 50, 40]


def yawed(seq, base, yaws):
    """`seq` rendered at `base` turned about the camera's y axis by each of
    `yaws` degrees."""
    import dataclasses

    poses = []
    for yaw in yaws:
        a = np.radians(yaw)
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses.append(T @ base)
    return dataclasses.replace(seq, poses=np.stack(poses))


def yaw_session(cfg, device, map_frames: int = 10, yaws=YAWS) -> dict:
    """The tests' localization session: `map_frames` of the synthetic
    forward sequence mapped, localization mode, then the last mapped view
    turned by each of `yaws` with `Capture` installed and the program's
    tracer on. Returns the session, its keyframes and map before the
    localization frames, the records, the rows of their comparison with
    the reference and the tracer's records."""
    from orbslam2_tpu_torch import profiling, synthetic
    from orbslam2_tpu_torch.pipeline.system import System

    seq = synthetic.textured_sequence(n_frames=map_frames, kind="forward", cam=cfg.camera)
    rot = yawed(seq, seq.poses[-1], yaws)
    slam = System(cfg, device=device)
    for i in range(len(seq)):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    slam.activate_localization_mode()
    n_kf = slam.num_keyframes()
    before = map_snapshot(slam.map)
    cap = Capture()
    cap.install()
    profiling.take()
    profiling.enable()
    try:
        for j in range(len(rot)):
            img, depth = rot.frame(j)
            slam.track_rgbd(img, depth, timestamp=(len(seq) + j) / 30.0)
    finally:
        profiling.disable()
        cap.uninstall()
    taken = profiling.take()
    c = cfg.camera
    s = ref.Settings(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf, width=c.width,
                     height=c.height, scale_factor=cfg.orb.scale_factor,
                     num_levels=cfg.orb.num_levels, max_local_kfs=cfg.map.max_local_keyframes,
                     max_local_points=cfg.map.max_local_points)
    return dict(slam=slam, n_kf=n_kf, before=before, records=cap.records,
                rows=compare(cap.records, slam.map, s), taken=taken, settings=s, n=len(rot))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="localization mode against its plain reference")
    ap.add_argument("--workload", default="tum3-rgbd-localize.fr3-localize")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--control-frames", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from slambench import cell as cellmod
    from slambench import run, tracing

    run.set_process_env()
    torch.set_num_threads(1)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("localize_parity: no CUDA device", file=sys.stderr)
        return 3
    from orbslam2_tpu_torch import profiling
    from orbslam2_tpu_torch.pipeline.system import System

    c = cellmod.load_cell(ROOT, args.workload)
    t0 = time.perf_counter()
    frames = run.Frames(c, dev)
    render_s = time.perf_counter() - t0
    slam = System(c.slam_config(), device=dev,
                  enable_loop_closing=bool(c.mix.get("loop_closing", True)))
    drv = run.Driver(c, frames, slam, args.seed, tracing.Recorder())
    t0 = time.perf_counter()
    drv.setup()
    slam.activate_localization_mode()
    setup_s = time.perf_counter() - t0
    m = slam.map
    n_kf, n_mp = int(m.kf_valid.sum()), int(m.mp_valid.sum())
    before = map_snapshot(m)
    cap = Capture()
    cap.install()
    profiling.take()
    profiling.enable()
    t0 = time.perf_counter()
    try:
        drv.run(drv.stream(), frames=args.frames)
    finally:
        profiling.disable()
        cap.uninstall()
    window_s = time.perf_counter() - t0
    counters = profiling.take()["counters"]
    changed = map_changes(before, slam.map)
    s = ref.Settings.from_settings(c.settings)
    t0 = time.perf_counter()
    rows = compare(cap.records, m, s)
    compare_s = time.perf_counter() - t0
    result = verdict(rows)
    steps = [r for r in cap.records if r["kind"] == "step"][:args.control_frames]
    control = verdict(compare(steps, m, s, precision=torch.bfloat16))
    states = [r.state.name for r in slam.results[-args.frames:]]
    line = dict(
        workload=args.workload, seed=args.seed,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        keyframes=n_kf, points=n_mp, render_s=render_s, setup_s=setup_s, window_s=window_s,
        window_frames=args.frames, lost=sum(st != "OK" for st in states),
        map_changed=changed, counters=counters, compare_s=compare_s, parity=result,
        control=dict(frames=control["compared"], dt_max_m=control["dt_max_m"],
                     drot_max_deg=control["drot_max_deg"], poses_ok=control["poses_ok"],
                     decisions_equal=control["decisions_equal"]),
        tolerances=dict(dt_m=DT_M, drot_deg=DROT_DEG, inliers_equal_share=INLIER_SHARE,
                        inliers_slack=INLIER_SLACK),
        peak_bytes=int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0)
    line["pass"] = bool(result["ok"] and not changed and not control["poses_ok"]
                        and counters.get("mapping.keyframes", 0) == 0
                        and counters.get("localization.frames", 0) == args.frames)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(line, rows=rows)))
    print(json.dumps(line), flush=True)
    return 0 if line["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
