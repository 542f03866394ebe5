"""The reference package's own outcomes for the loop-closing and
relocalization sessions that `chip_smoke.py` drives on the port: run on the
CPU, in one process with one JAX device and `pipeline_depth=0`.

    JAX_PLATFORMS=cpu python tools/loop_reference_targets.py [SESSION ...]

SESSION is any of `orbit640` (bench.py's segment B: the 170-frame orbit
plus a 35-frame revisit at 640x480 / 1000 features, `th_depth` 130),
`orbit320` (`tests/test_loop_reloc.py::test_orbit_loop_closes`'s
configuration), `reloc640` (the first 34 frames of the forward dolly at
bench.py's configuration, 3 black frames, then frame 10 again) and
`reloc_small` (the same at `tests/test_e2e_rgbd.py::small_cfg`),
`orbit320_pcg` (`orbit320` with `pose_graph_dense_max_k` 64, below its 96
keyframe slots, so each correction takes the PCG essential-graph solve) and
`longrun N` (`stress_longrun.py`'s configuration at `pipeline_depth=0`
over the first N frames of its repeated 620-frame orbit; N defaults to
800, one revolution and 180 frames of the second); the first four by
default. Prints one JSON line per session: loops closed, frames lost,
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
                n_inliers=int(slam.results[-1].num_inliers))


SESSIONS = {
    "orbit640": lambda: orbit(dataclasses.replace(
        BENCH, tracking=dataclasses.replace(BENCH.tracking, th_depth=130.0))),
    "orbit320": lambda: orbit(ORBIT320),
    "reloc640": lambda: reloc(BENCH),
    "reloc_small": lambda: reloc(SMALL),
    "orbit320_pcg": lambda: orbit(ORBIT320_PCG),
    "longrun": lambda n=800: orbit(LONGRUN, LONGRUN_REV, int(n) - LONGRUN_REV),
}
DEFAULT = ("orbit640", "orbit320", "reloc640", "reloc_small")


def main():
    args = sys.argv[1:] or list(DEFAULT)
    i = 0
    while i < len(args):
        name = args[i]
        # `longrun` takes its frame count as the next argument, when one is given
        extra = [args[i + 1]] if i + 1 < len(args) and args[i + 1].isdigit() else []
        i += 1 + len(extra)
        out = SESSIONS[name](*extra)
        print(json.dumps({"session": " ".join([name, *extra]), "devices": len(jax.devices()),
                          **out}), flush=True)


if __name__ == "__main__":
    main()
