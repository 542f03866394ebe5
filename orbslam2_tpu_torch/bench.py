"""The headline benchmark: the port's counterpart of `bench.py`.

    python -m orbslam2_tpu_torch.bench [--all-sensors] [--profile]
        [--events EVENTS.jsonl] [--device cuda|cpu]

Two live RGB-D segments through `System.track_rgbd` at bench.py's
640x480 configuration (`bench.py:83-103`; 1000 features, 96 keyframe
slots, 16384 points, local BA over 24 + 16 keyframes and 4096 points,
both loop-closer warm-ups), synchronous (`pipeline_depth=0`; bench.py
runs at 2, which the port does not do):

* A, the forward dolly: 72 frames of steady tracking and mapping;
* B, the orbit and its revisit (170 + 35 frames, `th_depth` 130): the
  revisit is where a loop can be detected, verified and corrected.

The frames are rendered by worker processes and staged on the device
before each segment; frames 0-7 of each warm up; the final `flush` is
counted in the last frame. The timing is closed loop: each frame's time
ends with its pose on the host. The headline is the measured frames over
their total time across both segments.

`--all-sensors` adds 24 stereo frames of the dolly and 24 monocular frames
of the lateral sequence (bench.py's mono configuration), frames/s over
frames 8-23. `--profile` shortens segment A to 24 frames and times
`fused.frame_and_keyframe_step` there with the device synchronised around
it (bench.py's `stages` block), then traces segment B's frames 8-47 with
`torch.profiler` and reports the host's time in CUDA calls that wait for
the device (stream, device and event synchronisation, and memory copies)
as a share of the frame, keyframe frames and other frames apart.

Prints one JSON line with bench.py's keys, plus `pipeline_depth`, the
card's `power_limit`, each segment's lost frames, its keyframe and other
frames' median ms and its K1 and K2 launches, and segment B's
loop-correction frames. Runs on
the card unless `--device cpu` is given, and fails without one.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import time

import numpy as np
import torch

from orbslam2_tpu_torch import config as c
from orbslam2_tpu_torch import drive, evaluation, kernels, profiling
from orbslam2_tpu_torch.pipeline import fused
from orbslam2_tpu_torch.pipeline.system import System

FORWARD = 72                 # segment A's frames
ORBIT, REVISIT = 170, 35     # segment B's orbit and revisit frames
WARMUP = 8                   # frames 0..7 of each segment are not timed
SENSOR_FRAMES = 24           # --all-sensors' stereo and mono segments
PROFILE_FORWARD = 24         # segment A's frames under --profile
PROFILE_WINDOW = (8, 48)     # segment B's frames traced under --profile
# CUDA runtime calls in which the host waits for the device
WAIT_CALLS = {"sync": ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"),
              "memcpy": ("cudaMemcpyAsync", "cudaMemcpy")}


def base_config() -> c.SlamConfig:
    """`bench.py:83-103`, synchronous."""
    return c.SlamConfig(
        sensor=c.Sensor.RGBD,
        camera=c.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0, fps=30.0),
        orb=c.OrbConfig(num_features=1000, feature_slots=1024),
        map=c.MapConfig(max_keyframes=96, max_points=16384, max_local_points=4096),
        tracking=c.TrackingConfig(th_depth=40.0, pipeline_depth=0),
        solver=c.SolverConfig(ba_max_points=4096, local_ba_iters_first=3,
                              local_ba_iters_second=4, ba_max_local_kfs=24, ba_max_fixed_kfs=16),
        vocab=c.VocabConfig(warmup_correction=True, warmup_reloc=True),
    )


def orbit_config(base: c.SlamConfig) -> c.SlamConfig:
    """Segment B: `th_depth` 130 (the orbit's walls are far)."""
    return dataclasses.replace(base, tracking=dataclasses.replace(base.tracking, th_depth=130.0))


def sensor_configs(base: c.SlamConfig) -> dict:
    """`bench.py:183-198`: stereo on the dolly, mono on the lateral
    sequence with its own ORB and tracking settings."""
    mono = dataclasses.replace(
        base, sensor=c.Sensor.MONOCULAR,
        orb=dataclasses.replace(base.orb, num_features=1200, feature_slots=1280,
                                candidates_per_level=4096),
        tracking=dataclasses.replace(base.tracking, th_depth=100.0, mono_init_min_matches=50,
                                     kf_min_gap=2))
    return {"stereo": (dataclasses.replace(base, sensor=c.Sensor.STEREO), "forward"),
            "mono": (mono, "lateral")}


def host_wait(prof, frames: range) -> dict:
    """Per frame of `frames` (each traced inside a `bench_frame_<i>`
    range), the host's microseconds in the CUDA calls of WAIT_CALLS and
    the frame's own microseconds."""
    spans, calls = {}, []
    for e in prof.events():
        if e.name.startswith("bench_frame_"):
            spans[int(e.name[len("bench_frame_"):])] = (e.time_range.start, e.time_range.end)
        else:
            for kind, names in WAIT_CALLS.items():
                if e.name in names:
                    calls.append((e.time_range.start, e.time_range.end - e.time_range.start, kind))
    out = {i: {"frame_us": spans[i][1] - spans[i][0], "sync": 0.0, "memcpy": 0.0, "calls": 0}
           for i in frames if i in spans}
    order = sorted(out, key=lambda i: spans[i][0])
    starts = [spans[i][0] for i in order]
    for start, dur, kind in calls:
        j = bisect.bisect_right(starts, start) - 1
        if j >= 0 and start < spans[order[j]][1]:
            row = out[order[j]]
            row[kind] += dur
            row["calls"] += 1
    return out


def wait_shares(per_frame: dict, kf_frames) -> dict:
    """The waits of `host_wait` summed over keyframe frames and over the
    other frames, each as a share of those frames' time."""
    out = {}
    for label, sel in (("keyframe_frames", lambda i: i in kf_frames),
                       ("other_frames", lambda i: i not in kf_frames)):
        rows = [r for i, r in per_frame.items() if sel(i)]
        frame_us = sum(r["frame_us"] for r in rows)
        sync_us, memcpy_us = sum(r["sync"] for r in rows), sum(r["memcpy"] for r in rows)
        out[label] = {"frames": len(rows), "frame_ms": frame_us / 1e3,
                      "sync_ms": sync_us / 1e3, "memcpy_ms": memcpy_us / 1e3,
                      "wait_calls": sum(r["calls"] for r in rows),
                      "share": (sync_us + memcpy_us) / frame_us if frame_us else None}
    return out


def run_segment(cfg, spec, n_frames: int, device, pool, profile: range | None = None):
    """One segment: its frames rendered and staged on `device`, then
    tracked closed loop with the final flush counted in the last frame.
    With `profile`, those frames are traced. Returns (session, seconds
    per frame, ATE over the tracked frames, frames lost, K1 and K2
    launches, the host waits of the traced frames or None)."""
    frames = pool.render(spec, range(n_frames), stereo=cfg.sensor == c.Sensor.STEREO)
    imgs = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    deps = torch.from_numpy(np.stack([f[1] for f in frames])).to(device)
    del frames
    seq = drive.sequence(spec)
    slam = System(cfg, device=device)
    track = {c.Sensor.RGBD: slam.track_rgbd, c.Sensor.STEREO: slam.track_stereo,
             c.Sensor.MONOCULAR: lambda img, _, timestamp: slam.track_monocular(img, timestamp)}
    step = track[cfg.sensor]
    prof, wall = None, []
    last_traced = min(profile.stop, n_frames) - 1 if profile is not None else -1
    kernels.launch_counts.update(hamming=0, pose_gn=0)
    for i in range(n_frames):
        if profile is not None and i == profile.start:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench_frame_{i}"):
            step(imgs[i], deps[i], timestamp=i / 30.0)
        wall.append(time.perf_counter() - t0)
        if i == last_traced:
            prof.stop()
    t0 = time.perf_counter()
    slam.flush()
    wall[-1] += time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    waits = host_wait(prof, profile) if prof is not None else None
    _, poses, tracked = slam.frame_poses()
    ate = (float(evaluation.ate_rmse(poses[tracked], seq.poses[tracked], align=True))
           if tracked.any() else float("nan"))
    return slam, wall, ate, int((~tracked).sum()), launches, waits


def segment_record(slam, wall, ate, lost, launches) -> dict:
    """bench.py's per-segment keys, plus frames lost, the median ms of
    keyframe frames and of other frames over the timed frames, and the
    segment's K1 and K2 launches."""
    ms_ = 1e3 * np.asarray(wall)
    timed = np.arange(WARMUP, len(wall))
    is_kf = np.isin(timed, drive.keyframe_frames(slam))
    med = lambda sel: float(np.median(ms_[timed][sel])) if sel.any() else None  # noqa: E731
    return {"fps": len(timed) / sum(wall[WARMUP:]), "frames": len(timed), "ate_rmse_m": ate,
            "keyframes": slam.num_keyframes(), "points": slam.num_points(),
            "lost_frames": lost, "keyframe_median_ms": med(is_kf), "other_median_ms": med(~is_kf),
            "launches": launches}


def run(device, all_sensors: bool = False, profile: bool = False,
        events: str | None = None) -> dict:
    base = base_config()
    timer = profiling.StageTimer(device)
    with drive.RenderPool() as pool:
        n_a = PROFILE_FORWARD if profile else FORWARD
        step_fn = fused.frame_and_keyframe_step
        if profile:
            fused.frame_and_keyframe_step = timer.wrap("frame+track+kf", step_fn)
        try:
            slam_a, wall_a, ate_a, lost_a, launches_a, _ = run_segment(
                base, (n_a, "forward", base.camera, 0), n_a, device, pool)
        finally:
            fused.frame_and_keyframe_step = step_fn
        n_b = ORBIT + REVISIT
        slam_b, wall_b, ate_b, lost_b, launches_b, waits = run_segment(
            orbit_config(base), (ORBIT, "orbit", base.camera, REVISIT), n_b, device, pool,
            profile=range(*PROFILE_WINDOW) if profile else None)
        sensor_fps = {}
        if all_sensors and not profile:
            for name, (cfg, kind) in sensor_configs(base).items():
                _, wall, *_ = run_segment(cfg, (SENSOR_FRAMES, kind, cfg.camera, 0),
                                               SENSOR_FRAMES, device, pool)
                sensor_fps[f"{name}_fps"] = (SENSOR_FRAMES - WARMUP) / sum(wall[WARMUP:])

    if events:
        with open(events, "w") as f:
            for tag, s in (("A", slam_a), ("B", slam_b)):
                for e in s.log.events:
                    rec = {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in e.items()}
                    rec["segment"] = tag
                    f.write(json.dumps(rec) + "\n")

    measured = (n_a - WARMUP) + (n_b - WARMUP)
    fps = measured / (sum(wall_a[WARMUP:]) + sum(wall_b[WARMUP:]))
    loops = slam_b.loop_closer.loops_closed if slam_b.loop_closer else 0
    orbit_loop = segment_record(slam_b, wall_b, ate_b, lost_b, launches_b)
    orbit_loop.update(loops_closed=loops, loop_frames=drive.frame_events(slam_b, "loop_closed"),
                      worst_frame_ms=1e3 * max(wall_b[WARMUP:]))
    extra = {
        "frames": measured, "ate_rmse_m": ate_a, "lost_frames": lost_a + lost_b,
        "loops_closed": loops, "forward": segment_record(slam_a, wall_a, ate_a, lost_a, launches_a),
        "orbit_loop": orbit_loop, "scene": "textured_room forward + orbit_revisit",
        **drive.device_fields(device),
    }
    if profile:
        stage_ms = 1e3 * np.asarray(timer.times["frame+track+kf"])
        tail = stage_ms[len(stage_ms) // 2:]
        extra["stages"] = {"frame+track+kf": {"n": len(stage_ms), "first_ms": stage_ms[0],
                                              "steady_ms": float(np.median(tail))}}
        extra["host_wait"] = {"window": list(PROFILE_WINDOW),
                              **wait_shares(waits, set(drive.keyframe_frames(slam_b)))}
    extra.update(sensor_fps)
    return {"metric": "tracking_fps", "value": fps, "unit": "frames/s/gpu",
            "vs_baseline": fps / 30.0, "pipeline_depth": base.tracking.pipeline_depth,
            "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all-sensors", action="store_true",
                    help="add the stereo and monocular segments' frames/s")
    ap.add_argument("--profile", action="store_true",
                    help="per-stage times and the host's share of waits for the device")
    ap.add_argument("--events", default=None, help="write both segments' events as JSON lines")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the sessions run (default: the CUDA device)")
    args = ap.parse_args(argv)
    out = run(drive.require_device(args.device), args.all_sensors, args.profile, args.events)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
