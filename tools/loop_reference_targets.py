"""The reference package's own outcomes for the loop-closing and
relocalization sessions that `chip_smoke.py` drives on the port: run on the
CPU, in one process with one JAX device, at `pipeline_depth=0` unless
`--depth N` asks for another.

    JAX_PLATFORMS=cpu python tools/loop_reference_targets.py [--depth N] [SESSION ...]

SESSION is any of `orbit640` (bench.py's segment B: the 170-frame orbit
plus a 35-frame revisit at 640x480 / 1000 features, `th_depth` 130),
`orbit320` (`tests/test_loop_reloc.py::test_orbit_loop_closes`'s
configuration), `reloc640` (the first 34 frames of the forward dolly at
bench.py's configuration, 3 black frames, then frame 10 again) and
`reloc_small` (the same at `tests/test_e2e_rgbd.py::small_cfg`),
`orbit320_pcg` (`orbit320` with `pose_graph_dense_max_k` 64, below its 96
keyframe slots, so each correction takes the PCG essential-graph solve) and
`longrun N` (`stress_longrun.py`'s configuration
over the first N frames of its repeated 620-frame orbit; N defaults to
800, one revolution and 180 frames of the second); the first four by
default; `dolly640` is bench.py's segment A (the 72-frame forward dolly at
its configuration, loop closing on), and `gap320` 60 frames of the dolly
at `tests/test_torch_mapping_slice.py`'s 320x240 configuration with frame
54 black (after 6 keyframes, so no auto-reset; at depth 2 the next frame's
dispatch inserts a keyframe before frame 54 is resolved LOST, which the
resolve then folds in as orphaned), with its per-frame states and poses
and its keyframe and relocalization events. Prints one JSON line per session: loops closed, frames lost,
ATE over the tracked frames (bench.py's definition), over all frames and
over the orbit's frames alone, the frame of each loop correction, the
keyframes' frames and the rejected Sim3 verifications, and for the
relocalization sessions the frame that relocalized and its translation
error to frame 10's ground truth.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from orbslam2_tpu.config import (  # noqa: E402
    CameraConfig, MapConfig, OrbConfig, SlamConfig, Sensor, SolverConfig, TrackingConfig,
    VocabConfig,
)
from orbslam2_tpu.io import synthetic  # noqa: E402
from orbslam2_tpu.pipeline.system import System  # noqa: E402
from orbslam2_tpu.pipeline.tracking import TrackState  # noqa: E402
from orbslam2_tpu.utils.evaluation import ate_rmse  # noqa: E402

BENCH = SlamConfig(
    sensor=Sensor.RGBD,
    camera=CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0, fps=30.0),
    orb=OrbConfig(num_features=1000, feature_slots=1024),
    map=MapConfig(max_keyframes=96, max_points=16384, max_local_points=4096),
    tracking=TrackingConfig(th_depth=40.0, pipeline_depth=0),
    solver=SolverConfig(ba_max_points=4096, local_ba_iters_first=3, local_ba_iters_second=4,
                        ba_max_local_kfs=24, ba_max_fixed_kfs=16),
)
ORBIT320 = SlamConfig(
    sensor=Sensor.RGBD,
    camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, fps=30.0,
                        width=320, height=240),
    orb=OrbConfig(num_features=400, feature_slots=512, candidates_per_level=1024),
    map=MapConfig(max_keyframes=96, max_points=16384, max_local_points=4096),
    tracking=TrackingConfig(th_depth=130.0),
)
# tests/test_torch_mapping_slice.py's CFG
MAPPING320 = SlamConfig(
    sensor=Sensor.RGBD,
    camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, width=320, height=240),
    orb=OrbConfig(num_features=300, feature_slots=320, candidates_per_level=2048),
    map=MapConfig(max_keyframes=32, max_points=8192, max_local_points=2048),
    tracking=TrackingConfig(th_depth=40.0),
    solver=SolverConfig(ba_max_points=2048, local_ba_iters_first=3, local_ba_iters_second=4,
                        ba_max_local_kfs=16, ba_max_fixed_kfs=16),
)
SMALL = SlamConfig(
    sensor=Sensor.RGBD,
    camera=CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0, fps=30.0),
    orb=OrbConfig(num_features=600, feature_slots=640, candidates_per_level=2048),
    map=MapConfig(max_keyframes=32, max_points=8192, max_local_points=4096),
    tracking=TrackingConfig(th_depth=40.0),
)
ORBIT320_PCG = dataclasses.replace(ORBIT320, solver=SolverConfig(pose_graph_dense_max_k=64))
# stress_longrun.py:64-82, synchronous
LONGRUN = SlamConfig(
    sensor=Sensor.RGBD,
    camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, fps=30.0,
                        width=320, height=240),
    orb=OrbConfig(num_features=400, feature_slots=512, candidates_per_level=1024),
    map=MapConfig(max_keyframes=512, max_points=65536, max_local_points=4096),
    tracking=TrackingConfig(th_depth=130.0, pipeline_depth=0),
    solver=SolverConfig(ba_max_points=2048, local_ba_iters_first=3, local_ba_iters_second=4,
                        ba_max_local_kfs=24, ba_max_fixed_kfs=16),
    vocab=VocabConfig(warmup_correction=True, warmup_reloc=True, reservoir_cap=262144),
)
LONGRUN_REV = 620


def _loop_frames(slam) -> list[int]:
    """The frame index during which each loop correction landed."""
    n_frames, out = 0, []
    for e in slam.log.events:
        if e["event"] == "frame":
            n_frames += 1
        elif e["event"] == "loop_closed":
            out.append(n_frames)
    return out


def orbit(cfg, n_orbit=170, n_revisit=35):
    """The orbit of `n_orbit` frames, its poses repeated for `n_revisit`
    more frames."""
    seq = synthetic.textured_sequence(n_frames=n_orbit, kind="orbit", cam=cfg.camera)
    reps = -(-(n_orbit + n_revisit) // n_orbit)
    seq = dataclasses.replace(seq, poses=np.concatenate([seq.poses] * reps)[:n_orbit + n_revisit])
    slam = System(cfg)
    t0 = time.perf_counter()
    for i in range(n_orbit + n_revisit):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    slam.flush()
    wall = time.perf_counter() - t0
    _, poses, tracked = slam.frame_poses()
    lc = slam.loop_closer
    return dict(
        frames=n_orbit + n_revisit,
        loops_closed=lc.loops_closed if lc is not None else 0,
        loop_frames=_loop_frames(slam),
        lost=int((~tracked).sum()),
        ate=float(ate_rmse(poses[tracked], seq.poses[tracked], align=True)),
        ate_all=float(ate_rmse(poses, seq.poses, align=True)),
        # the orbit alone, before the revisit and any correction
        ate_orbit=float(ate_rmse(poses[:n_orbit], seq.poses[:n_orbit], align=True)),
        keyframes=slam.num_keyframes(),
        points=slam.num_points(),
        gba_folds=sum(1 for e in slam.log.events if e["event"] == "gba_folded"),
        keyframe_frames=[i for i, r in enumerate(slam.results) if r.is_keyframe],
        lost_frames=np.nonzero(~tracked)[0].tolist(),
        sim3_fails=[(e["kf_id"], e["cand"], e["n_brute"], e["num_inliers"], e["n_guided"])
                    for e in slam.log.events if e["event"] == "loop_sim3_fail"],
        keyframes_inserted=int(slam.map.num_kf),
        edge_truncations=lc.edge_truncations if lc is not None else 0,
        cpu_wall_s=wall,
    )


def dolly(cfg, n_frames=72):
    """The forward dolly through `track_rgbd`, loop closing on."""
    seq = synthetic.textured_sequence(n_frames=n_frames, kind="forward", cam=cfg.camera)
    slam = System(cfg)
    for i in range(n_frames):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    _, poses, tracked = slam.frame_poses()
    return dict(frames=n_frames, lost=int((~tracked).sum()),
                ate=float(ate_rmse(poses, seq.poses, align=True)),
                keyframes=slam.num_keyframes(), points=slam.num_points(),
                keyframe_frames=[i for i, r in enumerate(slam.results) if r.is_keyframe],
                loops_closed=slam.loop_closer.loops_closed if slam.loop_closer else 0)


def gap(cfg, n_frames=60, black_at=54):
    """The forward dolly with frame `black_at` black."""
    seq = synthetic.textured_sequence(n_frames=n_frames, kind="forward", cam=cfg.camera)
    black = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    slam = System(cfg)
    for i in range(n_frames):
        img, depth = (black, black) if i == black_at else seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    _, poses, tracked = slam.frame_poses()
    return dict(frames=n_frames, black_at=black_at, states=[r.state.name for r in slam.results],
                keyframe_events=[[e["kf_id"], e["frame_id"], bool(e.get("orphaned"))]
                                 for e in slam.log.of("keyframe")],
                relocalized=[e["frame_id"] for e in slam.log.of("relocalized")],
                resets=len(slam.log.of("reset")), tracked=tracked.tolist(),
                poses=poses.tolist())


def reloc(cfg, n_map=34, n_black=3, revisit=10, tries=3):
    seq = synthetic.textured_sequence(n_frames=n_map, kind="forward", cam=cfg.camera)
    slam = System(cfg)
    for i in range(n_map):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    ok_before = slam.get_tracking_state() == TrackState.OK
    n_kf = slam.num_keyframes()
    black = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    for j in range(n_black):
        slam.track_rgbd(black, black, timestamp=(n_map + j) / 30.0)
    lost = slam.get_tracking_state() == TrackState.LOST
    img, depth = seq.frame(revisit)
    reloc_try = None
    for j in range(tries):
        slam.track_rgbd(img, depth, timestamp=(n_map + n_black + j) / 30.0)
        if slam.get_tracking_state() == TrackState.OK:
            reloc_try = j
            break
    T = slam.results[-1].Tcw
    err = float(np.linalg.norm((T @ np.linalg.inv(seq.poses[revisit]))[:3, 3]))
    return dict(ok_before=ok_before, keyframes=n_kf, lost_after_blackout=lost,
                relocalized_at_try=reloc_try, t_err=err,
                n_inliers=int(slam.results[-1].num_inliers),
                states=[r.state.name for r in slam.results],
                orphaned=[e["kf_id"] for e in slam.log.of("keyframe") if e.get("orphaned")])


def run_unfused(slam, frames, stereo: bool = False) -> None:
    """The unfused path, which no entry point of `System` drives: RGB-D
    (or stereo) initialization through `Tracker.process`, then every frame
    through `process_rgbd_fast` (`process_stereo_fast`); on each keyframe
    request the keyframe's insertion, its close-point depth seeds,
    `LocalMapper.process_keyframe(run_ba=False)`, `post_keyframe` (local BA
    and the cold `after_keyframe`), the culled keyframes' re-anchoring and
    `Tracker.on_new_keyframe`. `frames` holds (image, depth) or (left,
    right) pairs; the results land in `slam.results`, the map in
    `slam.map`. `chip_smoke.run_unfused_session` makes the same calls in
    the same order on the port."""
    import jax.numpy as jnp

    from orbslam2_tpu.slam_map import map_state as ms

    t, mapper = slam.tracker, slam.local_mapper
    fast = t.process_stereo_fast if stereo else t.process_rgbd_fast
    build = slam.builder.stereo if stereo else slam.builder.rgbd
    for i, (a, b) in enumerate(frames):
        a, b = jnp.asarray(a), jnp.asarray(b)
        res = fast(a, b, i / 30.0) if t.state == TrackState.OK else t.process(build(a, b, i / 30.0))
        if t.kf_request is not None:
            frame, Tcw, bind = t.kf_request
            t.kf_request = None
            st, kf = ms.add_keyframe(t.map, jnp.int32(frame.frame_id), Tcw, frame.xy, frame.ur,
                                     frame.depth, frame.octave, frame.angle, frame.desc,
                                     frame.valid, bind)
            kf = int(kf)
            st, seeds = t._create_depth_points(st, kf, frame, Tcw, bind)
            st = mapper.process_keyframe(st, kf, run_ba=False)
            t.map = slam.map = mapper.post_keyframe(st, kf, seeds)
            slam._drain_culls()
            t.on_new_keyframe(kf)
        slam.results.append(res)
    # the track steps donate the map they are given
    slam.map = t.map


def unfused(cfg, n_frames=72, stereo: bool = False):
    """The forward dolly through `run_unfused`, loop closing off."""
    seq = synthetic.textured_sequence(n_frames=n_frames, kind="forward", cam=cfg.camera)
    if stereo:
        cfg = dataclasses.replace(cfg, sensor=Sensor.STEREO)
        frames = [seq.stereo(i)[:2] for i in range(n_frames)]
    else:
        frames = [seq.frame(i) for i in range(n_frames)]
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False)
    t0 = time.perf_counter()
    run_unfused(slam, frames, stereo=stereo)
    wall = time.perf_counter() - t0
    _, poses, tracked = slam.frame_poses()
    return dict(frames=n_frames, tracked=int(tracked.sum()), lost=int((~tracked).sum()),
                ate=float(ate_rmse(poses[tracked], seq.poses[tracked], align=True)),
                keyframe_frames=[i for i, r in enumerate(slam.results) if r.is_keyframe],
                keyframes=slam.num_keyframes(), points=slam.num_points(),
                keyframes_inserted=int(slam.map.num_kf), cpu_wall_s=wall)


def at_depth(cfg, depth: int, **tracking):
    """`cfg` at `pipeline_depth` `depth`, with other tracking fields replaced."""
    return dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking, pipeline_depth=depth, **tracking))


# each takes the pipeline depth, then the session's own arguments
SESSIONS = {
    "orbit640": lambda d: orbit(at_depth(BENCH, d, th_depth=130.0)),
    "orbit320": lambda d: orbit(at_depth(ORBIT320, d)),
    "reloc640": lambda d: reloc(at_depth(BENCH, d)),
    "reloc_small": lambda d: reloc(at_depth(SMALL, d)),
    "dolly640": lambda d: dolly(at_depth(BENCH, d)),
    "gap320": lambda d: gap(at_depth(MAPPING320, d)),
    "orbit320_pcg": lambda d: orbit(at_depth(ORBIT320_PCG, d)),
    "longrun": lambda d, n=800: orbit(at_depth(LONGRUN, d), LONGRUN_REV, int(n) - LONGRUN_REV),
    # the unfused path at bench.py's sizes: RGB-D over segment A's 72
    # frames, stereo over 24 (depth 0 only: `run_unfused` has no FIFO)
    "unfused640": lambda d: unfused(BENCH),
    "unfused_stereo640": lambda d: unfused(BENCH, 24, stereo=True),
}
DEFAULT = ("orbit640", "orbit320", "reloc640", "reloc_small")


def main():
    args = sys.argv[1:]
    depth = 0
    if args[:1] == ["--depth"]:
        depth, args = int(args[1]), args[2:]
    args = args or list(DEFAULT)
    i = 0
    while i < len(args):
        name = args[i]
        # `longrun` takes its frame count as the next argument, when one is given
        extra = [args[i + 1]] if i + 1 < len(args) and args[i + 1].isdigit() else []
        i += 1 + len(extra)
        out = SESSIONS[name](depth, *extra)
        print(json.dumps({"session": " ".join([name, *extra]), "pipeline_depth": depth,
                          "devices": len(jax.devices()), **out}), flush=True)


if __name__ == "__main__":
    main()
