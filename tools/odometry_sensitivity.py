"""How the localization session's poses leave SO(3), and how its odometry
responds to a tiny perturbation.

    python tools/odometry_sensitivity.py [--device cuda|cpu] [--reference]
        [--bench] [--project vo|all] [--single] [--out OUT.json]

The session is the smoke's small localization session (320x240, 10
mapping frames, then the turn to 70 degrees at 2.5 a frame and back in
10-degree steps), or with `--bench` its localization path (bench.py's
configuration, the 72 mapping frames, then the first 44 frames of the
mbVO turn, to 110 degrees). It runs twice, the second time
with the result of every visual-odometry step's pose optimisation
multiplied by exp(1e-6 * noise) (seeded numpy noise, the same draws for
either package); `--single` runs the first alone. Per localization frame
it prints the mbVO flag, both runs' states, the first run's translation
error to the ground truth, how far its rotation is from orthonormal (max
|R^T R - I|), and the two runs' translation and rotation gaps (each
rotation projected onto SO(3) first).

`--device` is the port's device, the card unless `cpu` is asked for.
`--reference` runs the JAX package instead, on the CPU with one device.
`--project vo` puts every odometry step's rotation back onto SO(3) (SVD,
float64) in both runs; `--project all` every pose optimisation's of
tracking and odometry (the port only). About a minute a run on the card,
two (`--bench`: thirteen) on a CPU of eight cores.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

SMALL_YAWS = list(chip_smoke.LOC_YAWS[:28]) + [60.0, 50.0, 40.0]
BENCH_YAWS = list(chip_smoke.LOC_YAWS[:44])
SCALE = 1e-6


def so3(R: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    return U @ Vt


def adjust(T: np.ndarray, rng, scale: float, project: bool) -> np.ndarray:
    """`T` left-multiplied by exp(scale * noise), then, with `project`, its
    rotation put back onto SO(3); float64 in, float64 out."""
    T = np.asarray(T, np.float64)
    if scale:
        w, v = scale * rng.standard_normal(3), scale * rng.standard_normal(3)
        th = np.linalg.norm(w)
        Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        E = np.eye(4)
        E[:3, :3] = np.eye(3) + Wx * (np.sin(th) / th if th else 1.0)
        E[:3, :3] += Wx @ Wx * ((1 - np.cos(th)) / th ** 2 if th else 0.5)
        E[:3, 3] = v
        T = E @ T
    if project:
        T = T.copy()
        T[:3, :3] = so3(T[:3, :3])
    return T


def port_session(cfg, n_map: int, yaws, scale: float, project: str | None, device: str):
    import torch

    from orbslam2_tpu_torch.pipeline import fused, tracking

    rng = np.random.default_rng(0)
    plain_vo, plain_opt = tracking.Tracker.visual_odometry, tracking.pose_optimize_fast

    def as_tensor(T, like):
        return torch.as_tensor(T, dtype=like.dtype, device=like.device)

    def vo(self, *args, **kw):
        Tcw_pred, r = plain_vo(self, *args, **kw)
        T = adjust(r.Tcw.cpu().numpy(), rng, scale, project == "vo")
        return Tcw_pred, r._replace(Tcw=as_tensor(T, r.Tcw))

    def optimize(*args, **kw):
        r = plain_opt(*args, **kw)
        return r._replace(Tcw=as_tensor(adjust(r.Tcw.cpu().numpy(), None, 0.0, True), r.Tcw))

    if scale or project == "vo":
        tracking.Tracker.visual_odometry = vo
    if project == "all":
        tracking.pose_optimize_fast = fused.pose_optimize_fast = optimize
    try:
        slam, _, _, frames, _ = chip_smoke.run_localization_session(cfg, n_map, tuple(yaws),
                                                                    torch.device(device))
    finally:
        tracking.Tracker.visual_odometry = plain_vo
        tracking.pose_optimize_fast = fused.pose_optimize_fast = plain_opt
    poses = np.stack([r.Tcw for r in slam.results[-len(yaws):]])
    return poses, [f["state"] for f in frames], [f["vo"] for f in frames]


def reference_config(cfg):
    """The reference's twin of a port config: the same class by name,
    field by field, enums by member name."""
    from orbslam2_tpu import config as ref_config

    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cls = getattr(ref_config, type(cfg).__name__)
        return cls(**{f.name: reference_config(getattr(cfg, f.name))
                      for f in dataclasses.fields(cfg) if f.init})
    if isinstance(cfg, enum.Enum):
        return getattr(ref_config, type(cfg).__name__)[cfg.name]
    return cfg


def reference_session(cfg, n_map: int, yaws, scale: float, project: str | None):
    import jax
    import jax.numpy as jnp

    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.ops import match
    from orbslam2_tpu.pipeline.system import System
    from orbslam2_tpu.pipeline.tracking import Tracker
    from orbslam2_tpu.solvers import pose_opt

    cfg = reference_config(cfg)
    seq = synthetic.textured_sequence(n_frames=n_map, kind="forward", seed=0, cam=cfg.camera)
    turn = dataclasses.replace(seq, poses=chip_smoke.yawed_poses(seq.poses[-1], yaws))
    rng = np.random.default_rng(0)
    plain_search, plain_opt = match.search_frame_to_frame, pose_opt.pose_optimize
    plain_step = Tracker.localization_vo_step
    # inside the odometry step, the pose optimisation that follows its
    # frame-to-frame search (relocalization, tried first, makes none)
    in_vo = []

    def search(*args, **kw):
        in_vo.append(True)
        return plain_search(*args, **kw)

    def optimize(*args, **kw):
        r = plain_opt(*args, **kw)
        if not in_vo:
            return r
        in_vo.clear()
        T = adjust(jax.device_get(r.Tcw), rng, scale, project == "vo")
        return r._replace(Tcw=jnp.asarray(T, jnp.float32))

    def step(self, frame, db):
        match.search_frame_to_frame, pose_opt.pose_optimize = search, optimize
        try:
            return plain_step(self, frame, db)
        finally:
            match.search_frame_to_frame, pose_opt.pose_optimize = plain_search, plain_opt
            in_vo.clear()

    if scale or project:
        Tracker.localization_vo_step = step
    try:
        slam = System(cfg)
        for i in range(n_map):
            img, depth = seq.frame(i)
            slam.track_rgbd(img, depth, timestamp=i / 30.0)
        slam.activate_localization_mode()
        states, vo = [], []
        for j in range(len(yaws)):
            img, depth = turn.frame(j)
            slam.track_rgbd(img, depth, timestamp=(n_map + j) / 30.0)
            states.append(slam.results[-1].state.name)
            vo.append(bool(slam.tracker.mb_vo))
    finally:
        Tracker.localization_vo_step = plain_step
    poses = np.stack([np.asarray(r.Tcw) for r in slam.results[-len(yaws):]])
    return poses, states, vo


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--reference", action="store_true")
    p.add_argument("--bench", action="store_true")
    p.add_argument("--project", choices=("vo", "all"))
    p.add_argument("--single", action="store_true")
    p.add_argument("--out")
    args = p.parse_args()
    if args.bench:
        cfg, n_map, yaws = chip_smoke.bench_config(), chip_smoke.MAP_FRAMES, BENCH_YAWS
    else:
        cfg, n_map, yaws = chip_smoke.small_config(), chip_smoke.SMALL_LOC_MAP_FRAMES, SMALL_YAWS
    scales = (0.0,) if args.single else (0.0, SCALE)
    if args.reference:
        if args.project == "all":
            sys.exit("--project all reaches into the port's tracking only")
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        label = "reference, cpu"
        runs = [reference_session(cfg, n_map, yaws, s, args.project) for s in scales]
    else:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            sys.exit("no CUDA device; pass --device cpu to run on the CPU")
        label = f"port, {args.device}"
        if args.device == "cuda":
            from orbslam2_tpu_torch import kernels

            kernels.build()
            label += f", {chip_smoke.card_line()}"
        chip_smoke.start_render_pool()
        try:
            runs = [port_session(cfg, n_map, yaws, s, args.project, args.device) for s in scales]
        finally:
            chip_smoke.stop_render_pool()
    a, sa, vo = runs[0]
    sb = runs[-1][1]
    dt, deg = chip_smoke.pose_gaps(a, runs[-1][0])
    truth = chip_smoke.yawed_poses(chip_smoke._sequence((n_map, "forward", cfg.camera, 0)).poses[-1],
                                   yaws)
    err = np.linalg.norm(np.einsum("nij,njk->nik", a.astype(np.float64),
                                   np.linalg.inv(truth))[:, :3, 3], axis=1)
    R = a[:, :3, :3].astype(np.float64)
    drift = np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max(axis=(1, 2))
    print(f"{label}; {cfg.camera.width}x{cfg.camera.height}; projected: {args.project}; "
          f"perturbation {SCALE if len(scales) > 1 else 0:g} per odometry step")
    print("frame yaw mbVO states err_m |RtR-I| dt_m rot_deg")
    for j, y in enumerate(yaws):
        print(j, y, vo[j], sa[j], sb[j], f"{err[j]:.3e}", f"{drift[j]:.1e}", f"{dt[j]:.3e}",
              f"{deg[j]:.3e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(run=label, width=cfg.camera.width, project=args.project,
                           scale=SCALE if len(scales) > 1 else 0.0, yaws=yaws, mb_vo=vo,
                           states=[sa, sb], err_m=err.tolist(), orthonormality=drift.tolist(),
                           dt_m=dt.tolist(), rot_deg=deg.tolist()), f)


if __name__ == "__main__":
    main()
