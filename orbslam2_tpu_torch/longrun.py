"""The long live session: the port's counterpart of `stress_longrun.py`.

    python -m orbslam2_tpu_torch.longrun [--frames 2604] [--out LONGRUN.json]
        [--events EVENTS.jsonl] [--device cuda|cpu]

2604 frames of the 320x240 textured-room orbit (620 frames a revolution,
4.2 revolutions) through `System.track_rgbd` at `stress_longrun.py`'s
configuration: 400 features, `max_keyframes=512`, `max_points=65536`,
`reservoir_cap=262144`, both loop-closer warm-ups, synchronous
(`pipeline_depth=0`; `stress_longrun.py` runs at 2). A pool that fills
recycles its slots (`LocalMapper._pressure_cull`; this sequence inserts
about 180 keyframes, so the 512 slots do not fill), and past
`pose_graph_dense_max_k` (128) every loop correction solves the essential
graph with the PCG. The frames are rendered by worker processes before
the timed loop; each frame's time ends with its pose on the host.

Prints a line per window of 100 frames, then one JSON line with
`stress_longrun.py`'s keys, plus `pipeline_depth`, the card's `power_limit`,
`peak_device_bytes`, the keyframes' frames, the frame and ms of each loop
correction and of each vocabulary retrain, the essential-graph solves by
kind (PCG or dense; the loop closer's warm-up is not counted), the K1 and
K2 launches of the session, and the seconds the rendering took. Runs on
the card unless `--device cpu` is given, and fails without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from orbslam2_tpu_torch import config as c
from orbslam2_tpu_torch import drive, evaluation, kernels
from orbslam2_tpu_torch.pipeline import loop_closing
from orbslam2_tpu_torch.pipeline.system import System
from orbslam2_tpu_torch.solvers import pose_graph
from orbslam2_tpu_torch.vocab import bow

REVOLUTION = 620   # frames a revolution of the orbit
WARMUP = 10        # frames before the timed run
WINDOW = 100       # frames per fps window


def longrun_config() -> c.SlamConfig:
    """`stress_longrun.py:64-82`, synchronous."""
    return c.SlamConfig(
        sensor=c.Sensor.RGBD,
        camera=c.CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, fps=30.0,
                              width=320, height=240),
        orb=c.OrbConfig(num_features=400, feature_slots=512, candidates_per_level=1024),
        map=c.MapConfig(max_keyframes=512, max_points=65536, max_local_points=4096),
        tracking=c.TrackingConfig(th_depth=130.0, pipeline_depth=0),
        solver=c.SolverConfig(ba_max_points=2048, local_ba_iters_first=3,
                              local_ba_iters_second=4, ba_max_local_kfs=24,
                              ba_max_fixed_kfs=16),
        vocab=c.VocabConfig(warmup_correction=True, warmup_reloc=True, reservoir_cap=262144),
    )


class LoopProbe:
    """Counts, for one session, the essential-graph solves by kind and the
    vocabulary retrains, each with the frame it came in (`frame`, which
    the caller advances), by wrapping `pose_graph.optimize_pose_graph_pcg`,
    `pose_graph.optimize_pose_graph` and `LoopCloser._retrain_vocabulary`;
    what the loop closer's warm-up runs on its throwaway map is not
    counted. Launches nothing itself; `close()` restores the functions."""

    def __init__(self):
        self.frame = 0
        self.solves: list[tuple[int, str]] = []
        self.retrains: list[int] = []
        self._in_warmup = False
        self._saved = [(pose_graph, "optimize_pose_graph_pcg"), (pose_graph, "optimize_pose_graph"),
                       (loop_closing.LoopCloser, "_retrain_vocabulary"),
                       (loop_closing.LoopCloser, "warmup_correction")]
        self._saved = [(owner, name, getattr(owner, name)) for owner, name in self._saved]
        pcg, dense, retrain, warmup = (fn for _, _, fn in self._saved)

        def solve(kind, fn):
            def wrapped(*a, **k):
                if not self._in_warmup:
                    self.solves.append((self.frame, kind))
                return fn(*a, **k)
            return wrapped

        def counted_retrain(lc, state):
            if not self._in_warmup:
                self.retrains.append(self.frame)
            return retrain(lc, state)

        def flagged_warmup(lc, state):
            self._in_warmup = True
            try:
                return warmup(lc, state)
            finally:
                self._in_warmup = False

        pose_graph.optimize_pose_graph_pcg = solve("pcg", pcg)
        pose_graph.optimize_pose_graph = solve("dense", dense)
        loop_closing.LoopCloser._retrain_vocabulary = counted_retrain
        loop_closing.LoopCloser.warmup_correction = flagged_warmup

    def counts(self) -> dict:
        return {kind: sum(k == kind for _, k in self.solves) for kind in ("pcg", "dense")}

    def close(self) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def run(cfg: c.SlamConfig, n_frames: int, device: torch.device) -> tuple[dict, System]:
    """The session over `n_frames` frames of the repeated orbit. Returns
    (the JSON record, the session)."""
    if n_frames <= WARMUP:
        raise ValueError(f"--frames must exceed the {WARMUP} warm-up frames")
    spec = (REVOLUTION, "orbit", cfg.camera, max(0, n_frames - REVOLUTION))
    t0 = time.perf_counter()
    with drive.RenderPool() as pool:
        frames = pool.render(spec, range(n_frames))
    render_s = time.perf_counter() - t0
    seq = drive.sequence(spec)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    probe = LoopProbe()
    kernels.launch_counts.update(hamming=0, pose_gn=0)
    try:
        slam = System(cfg, device=device)
        wall, decay = [], []
        t_run0 = None
        for i, (img, depth) in enumerate(frames):
            probe.frame = i
            if i == WARMUP:
                t_run0 = time.perf_counter()
            t0 = time.perf_counter()
            slam.track_rgbd(img, depth, timestamp=i / 30.0)
            wall.append(time.perf_counter() - t0)
            if i >= WARMUP and (i + 1) % WINDOW == 0:
                w = wall[max(i - WINDOW + 1, WARMUP):]
                decay.append({"frame": i + 1, "fps": len(w) / sum(w),
                              "keyframes": slam.num_keyframes(),
                              "keyframes_inserted": int(slam.map.num_kf),
                              "points": slam.num_points()})
                print(f"# frame {i + 1}: {decay[-1]}", flush=True)
        probe.frame = n_frames
        t0 = time.perf_counter()
        slam.flush()
        wall[-1] += time.perf_counter() - t0
        total = time.perf_counter() - t_run0
        launches = dict(kernels.launch_counts)
    finally:
        probe.close()

    _, poses, tracked = slam.frame_poses()
    ate = evaluation.ate_rmse(poses[tracked], seq.poses[:n_frames][tracked], align=True)
    lc = slam.loop_closer
    steady_ms = 1e3 * np.asarray(wall[WARMUP:])

    def frame_ms(f):
        return 1e3 * wall[min(f, n_frames - 1)]

    out = {
        "metric": "longrun_live_session",
        "frames": n_frames,
        "fps_overall": (n_frames - WARMUP) / total,
        "ate_rmse_m": float(ate),
        "lost_frames": int((~tracked).sum()),
        "keyframes_live": slam.num_keyframes(),
        "keyframes_inserted": int(slam.map.num_kf),
        "vocab_words": bow.num_words(lc.codebook) if lc else 0,
        "points_live": slam.num_points(),
        "loops_closed": lc.loops_closed if lc else 0,
        "edge_truncations": lc.edge_truncations if lc else 0,
        "obs_truncations": lc.obs_truncations if lc else 0,
        "fps_decay": decay,
        "event_counts": slam.log.counts(),
        "lost_at_frames": [int(e["frame_id"]) for e in slam.log.of("frame")
                           if e.get("state") == "LOST"],
        "loop_closed_at_kfs": [int(e.get("matched_kf", -1)) for e in slam.log.of("loop_closed")],
        "max_frame_ms": float(steady_ms.max()),
        "p99_frame_ms": float(np.percentile(steady_ms, 99)),
        **drive.device_fields(device),
        "note": "4.2-revolution orbit through a 512-slot keyframe pool (covisibility to the "
                "start breaks until a loop closes); a stand-in for KITTI 00, which is not in the "
                "repository",
        "pipeline_depth": cfg.tracking.pipeline_depth,
        "peak_device_bytes": drive.peak_device_bytes(device),
        "keyframe_frames": drive.keyframe_frames(slam),
        "loop_corrections": [{"frame": f, "ms": frame_ms(f)}
                             for f in drive.frame_events(slam, "loop_closed")],
        "vocab_retrains": [{"frame": f, "ms": frame_ms(f)} for f in probe.retrains],
        "pose_graph_solves": probe.counts(),
        "launches": launches,
        "render_s": render_s,
    }
    return out, slam


def write_events(slam, path: str) -> None:
    with open(path, "w") as f:
        for e in slam.log.events:
            f.write(json.dumps({k: (v.tolist() if hasattr(v, "tolist") else v)
                                for k, v in e.items()}) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2604,
                    help="frames of the repeated orbit (default 2604, 4.2 revolutions)")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--events", default=None, help="write the event stream here as JSON lines")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the session runs (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = drive.require_device(args.device)
    out, slam = run(longrun_config(), args.frames, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if args.events:
        write_events(slam, args.events)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
