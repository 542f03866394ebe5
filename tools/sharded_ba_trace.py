"""Each Levenberg-Marquardt iteration of the sharded BA on the smoke's
problem (`chip_smoke.scaling_ba_problem`: bench_scaling.py's C=64,
P=32768, O=8, seed 0), with both camera solvers: the cost and lambda
after it, and whether the step was taken.

    JAX_PLATFORMS=cpu python tools/sharded_ba_trace.py reference [--iters 10]
    python tools/sharded_ba_trace.py port [--device cuda|cpu] [--iters 10]

`reference` runs the JAX package's `sharded_bundle_adjust` on the CPU over
1 and 8 virtual devices and imports nothing of the port; `port` runs the
port's at world size 1 (this process the one rank of its group), on the
card unless `--device cpu`, and imports no JAX. Each run is a chain of
one-iteration calls, lambda carried from call to call as the LM loop
carries it. Prints a line per iteration, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import SHARD_CG, scaling_ba_problem  # noqa: E402

SOLVERS = ("direct", "pcg")


def chain(step, cam, pts, iters: int, lam: float = 1e-4) -> list[dict]:
    """`iters` calls of `step(cam, pts, lam) -> (cam, pts, cost)`, each one
    LM iteration; a step was taken when the cameras moved (a rejected step
    returns them unchanged), and lambda then halves, else quadruples,
    clipped to [1e-9, 1e3] as in the LM loop."""
    import numpy as np

    rows = []
    for _ in range(iters):
        cam_new, pts, cost = step(cam, pts, lam)
        taken = not np.array_equal(np.asarray(cam_new), np.asarray(cam))
        lam = float(np.clip(np.float32(lam) * np.float32(0.5 if taken else 4.0), 1e-9, 1e3))
        rows.append({"cost": float(cost), "lam": lam, "taken": taken})
        cam = cam_new
    return rows


def reference(iters: int) -> dict:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from orbslam2_tpu.config import CameraConfig
    from orbslam2_tpu.geometry.camera import Intrinsics
    from orbslam2_tpu.parallel import sharded_ba
    from orbslam2_tpu.solvers import ba

    K = Intrinsics.from_config(CameraConfig(fx=480.0, fy=480.0, bf=240.0))
    prob = ba.BAProblem(**{k: jnp.asarray(v) for k, v in scaling_ba_problem().items()})
    out = {}
    for n in (1, 8):
        mesh = sharded_ba.make_points_mesh(n)
        for solver in SOLVERS:
            def step(cam, pts, lam):
                return sharded_ba.sharded_bundle_adjust(
                    prob._replace(cam_Tcw=cam, points=pts), K, mesh, iters=1, lam0=lam,
                    camera_solver=solver, cg_iters=SHARD_CG)

            out[f"reference, {n} device(s), {solver}"] = chain(step, prob.cam_Tcw, prob.points,
                                                               iters)
    return out


def port(iters: int, device: str) -> dict:
    import torch

    from orbslam2_tpu_torch import convert
    from orbslam2_tpu_torch.config import CameraConfig
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.parallel import group, sharded_ba

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    K = Intrinsics.from_config(CameraConfig(fx=480.0, fy=480.0, bf=240.0), device)
    prob = convert.ba_problem_from_numpy(scaling_ba_problem(), device)
    out = {}
    store = os.path.join(tempfile.mkdtemp(prefix="trace-group-"), "store")
    with group.member(0, 1, store, device):
        for solver in SOLVERS:
            def step(cam, pts, lam):
                cam, pts, cost = sharded_ba.sharded_bundle_adjust(
                    prob._replace(cam_Tcw=cam.to(device), points=pts), K, iters=1, lam0=lam,
                    camera_solver=solver, cg_iters=SHARD_CG)
                return cam.cpu(), pts, cost

            out[f"port on {device}, world size 1, {solver}"] = chain(
                step, prob.cam_Tcw.cpu(), prob.points, iters)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("which", choices=["reference", "port"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="the port's device (port only)")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    runs = reference(args.iters) if args.which == "reference" else port(args.iters, args.device)
    if args.which == "port" and args.device == "cuda":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip(), flush=True)
    for name, rows in runs.items():
        print(name, flush=True)
        for i, r in enumerate(rows, 1):
            print(f"  {i}: cost {r['cost']!r}, lambda {r['lam']:.3g}, "
                  f"{'taken' if r['taken'] else 'rejected'}", flush=True)
    print(json.dumps(runs), flush=True)


if __name__ == "__main__":
    main()
