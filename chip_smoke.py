"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile the hand-written kernels (`orbslam2_tpu_torch/csrc`);
3. K1 (Hamming distance) on the card against its plain PyTorch version,
   exact, and both timed with CUDA events;
4. K2 (pose Gauss-Newton) on the card against its plain version, Tcw to
   atol 1e-4 and equal inlier sets, and both timed;
5. the tracking path: `System.track_rgbd` over 40 frames of the synthetic
   textured-room dolly at the 640x480 / 1000-feature bench configuration,
   mapping and loop closing off. Every frame must be tracked with ATE
   < 0.01 m, and the kernel launch counts show the path went through K1
   and K2 (at least 3 launches each per tracked frame);
6. that session at a small size on the card and on the CPU (plain
   versions), per-frame poses within 5 mm and 0.2 degrees;
7. the mapping path: the same entry point over 72 frames at bench.py's
   configuration with local mapping on (loop closing off). All 72 frames
   tracked, ATE < 0.01 m, 8-24 keyframes, more than 2000 points, local BA
   on at least 8 keyframes and K1 launched inside every keyframe step;
   K1 is then timed at the union-fuse shape the keyframe steps launched;
8. the mapping session at a small size (320x240, 18 frames) on the card
   and on the CPU: the same keyframes (frames 0, 6 and 17) and per-frame
   poses within 5 mm and 0.2 degrees.

The launch counts are set to 0 just before each path is driven and read
just after; the kernels line sums the two paths. The last two lines are
a JSON object of the kernels' launch counts, errors and times, and the
JSON result line. Exits non-zero, printing no result, when no CUDA device
is available.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL_K2_TCW = 1e-4         # float32 GN with another summation order than torch's
ATE_LIMIT_M = 0.01        # the reference on the CPU gives 0.0041 m here
N_FRAMES = 40             # without mapping the first keyframe's points stay in view to ~70
TIMED_FROM = 8            # frames/s from frame 8 on (0..7 warm up)
SMALL_DT_M, SMALL_DEG = 5e-3, 0.2
MAP_FRAMES = 72           # bench.py's forward segment
MAP_ATE_LIMIT_M = 0.01    # the reference on the CPU gives 0.00312 m here
MAP_KF_RANGE = (8, 24)    # the reference makes 14 keyframes
MAP_MIN_POINTS = 2000     # the reference ends with 4712 points
MAP_MIN_BA = 8
SMALL_MAP_FRAMES, SMALL_MAP_KFS = 18, [0, 6, 17]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events, after
    one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rand_desc(rng, n: int, device) -> torch.Tensor:
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def check_k1(device) -> dict:
    from orbslam2_tpu_torch.ops import cuda_hamming, hamming

    rng = np.random.default_rng(0)
    timed = {}
    for n, m in [(1024, 1024), (4096, 1024), (100, 300), (1, 1)]:
        a, b = rand_desc(rng, n, device), rand_desc(rng, m, device)
        got = cuda_hamming.distance_matrix_cuda(a, b)
        ref = hamming.distance_matrix(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"K1 {n}x{m}: {int((got != ref).sum())} entries differ from the plain version")
        print(f"K1 {n}x{m}: exact", flush=True)
        if n >= 1024:
            k = time_ms(lambda: cuda_hamming.distance_matrix_cuda(a, b))
            p = time_ms(lambda: hamming.distance_matrix(a, b))
            timed[(n, m)] = (k, p)
            print(f"K1 {n}x{m}: kernel {k:.4f} ms, plain {p:.4f} ms (median of 20)", flush=True)
    k, p = timed[(4096, 1024)]
    return {"name": "hamming_distance_matrix", "route": "cuda",
            "source": "orbslam2_tpu_torch/csrc/hamming.cu",
            "replaces": "orbslam2_tpu/ops/pallas_hamming.py:55",
            "max_abs_err": 0, "ms": k, "plain_ms": p,
            "shape": "4096x1024", "ms_1024x1024": timed[(1024, 1024)][0],
            "plain_ms_1024x1024": timed[(1024, 1024)][1]}


def make_pose_problem(rng, device, n=1024, n_real=700, n_out=80, noise=0.5, stereo_frac=0.6):
    """The reference's pose-optimisation test problem: points in front of
    a camera moved by a known twist, noisy pixels, gross outliers, and NaN
    in the padded slots."""
    from orbslam2_tpu_torch.geometry import se3
    from orbslam2_tpu_torch.solvers.pose_opt import PoseObservations

    fx = fy = 480.0
    cx, cy, bf = 319.5, 239.5, 48.0
    pw = np.c_[rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)].astype(np.float32)
    T_true = se3.exp_se3(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03, 0.01]))
    pc = se3.apply(T_true, torch.from_numpy(pw)).numpy()
    u = fx * pc[:, 0] / pc[:, 2] + cx
    v = fy * pc[:, 1] / pc[:, 2] + cy
    uv = np.c_[u, v] + rng.normal(0, noise, (n, 2))
    ur = u - bf / pc[:, 2] + rng.normal(0, noise, n)
    ur = np.where(rng.random(n) < stereo_frac, ur, -1.0).astype(np.float32)
    out_idx = rng.choice(n_real, n_out, replace=False)
    uv[out_idx] += rng.normal(0, 30, (n_out, 2))
    mask = np.arange(n) < n_real
    uv[~mask] = np.nan
    obs = PoseObservations(
        pw=torch.from_numpy(pw).to(device),
        uv=torch.from_numpy(uv.astype(np.float32)).to(device),
        ur=torch.from_numpy(ur).to(device),
        inv_sigma2=torch.ones(n, device=device),
        mask=torch.from_numpy(mask).to(device),
    )
    return obs


def check_k2(device) -> dict:
    from orbslam2_tpu_torch import config
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.solvers import cuda_pose_opt, pose_opt

    cam = config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
    K = Intrinsics.from_config(cam, device)
    T0 = torch.eye(4, device=device)
    rng = np.random.default_rng(0)
    worst = 0.0
    for n, n_real, n_out in [(1024, 700, 80), (700, 600, 40)]:
        obs = make_pose_problem(rng, device, n=n, n_real=n_real, n_out=n_out)
        for rounds, iters in [(2, 6), (3, 6), (4, 6), (4, 10)]:
            got = cuda_pose_opt.pose_optimize_cuda(T0, obs, K, rounds=rounds, iters=iters)
            ref = pose_opt.pose_optimize(T0, obs, K, rounds=rounds, iters=iters)
            torch.cuda.synchronize()
            err = float((got.Tcw - ref.Tcw).abs().max())
            same = torch.equal(got.inliers, ref.inliers)
            chi2_err = float((got.chi2 - ref.chi2)[obs.mask].abs().max())
            print(f"K2 N={n} {rounds}x{iters}: Tcw max err {err:.3e}, inliers equal {same}"
                  f" ({int(got.num_inliers)}), chi2 max err {chi2_err:.3e}", flush=True)
            if not (err <= TOL_K2_TCW and same):
                fail(f"K2 N={n} {rounds}x{iters} disagrees with the plain version")
            worst = max(worst, err)
    obs = make_pose_problem(np.random.default_rng(1), device)
    k = time_ms(lambda: cuda_pose_opt.pose_optimize_cuda(T0, obs, K, rounds=4, iters=6))
    p = time_ms(lambda: pose_opt.pose_optimize(T0, obs, K, rounds=4, iters=6))
    print(f"K2 N=1024 4x6: kernel {k:.4f} ms, plain {p:.4f} ms (median of 20)", flush=True)
    return {"name": "pose_gn", "route": "cuda",
            "source": "orbslam2_tpu_torch/csrc/pose_gn.cu",
            "replaces": "orbslam2_tpu/solvers/pallas_pose_opt.py:242",
            "max_abs_err": worst, "ms": k, "plain_ms": p, "shape": "N=1024, 4x6"}


def bench_config(width: int = 640, height: int = 480, features: int = 1000,
                 slots: int = 1024, points: int = 16384, local_points: int = 4096,
                 keyframes: int = 96, ba_points: int = 4096, ba_local: int = 24,
                 ba_fixed: int = 16):
    """bench.py's camera, ORB, map and local-BA sizes, synchronous."""
    from orbslam2_tpu_torch import config as c

    s = width / 640.0
    return c.SlamConfig(
        sensor=c.Sensor.RGBD,
        camera=c.CameraConfig(fx=480.0 * s, fy=480.0 * s, cx=width / 2 - 0.5,
                              cy=height / 2 - 0.5, bf=48.0 * s, fps=30.0,
                              width=width, height=height),
        orb=c.OrbConfig(num_features=features, feature_slots=slots),
        map=c.MapConfig(max_keyframes=keyframes, max_points=points,
                        max_local_points=local_points),
        tracking=c.TrackingConfig(th_depth=40.0, pipeline_depth=0),
        solver=c.SolverConfig(ba_max_points=ba_points, local_ba_iters_first=3,
                              local_ba_iters_second=4, ba_max_local_kfs=ba_local,
                              ba_max_fixed_kfs=ba_fixed),
    )


def small_config():
    """The 320x240 / 300-feature configuration of the CPU tests."""
    return bench_config(width=320, height=240, features=300, slots=320, points=8192,
                        local_points=2048, keyframes=32, ba_points=2048, ba_local=16)


def run_session(cfg, n_frames: int, device, mapping: bool = False):
    """Drive System.track_rgbd over the forward dolly with the frames staged
    on `device` first. Returns (slam, seq, per-frame seconds); each frame
    ends in a host read of its pose, so its time is complete."""
    from orbslam2_tpu_torch import synthetic
    from orbslam2_tpu_torch.pipeline.system import System

    seq = synthetic.textured_sequence(n_frames=n_frames, kind="forward", seed=0, cam=cfg.camera)
    frames = [seq.frame(i) for i in range(n_frames)]
    imgs = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    deps = torch.from_numpy(np.stack([f[1] for f in frames])).to(device)
    slam = System(cfg, device=device, enable_mapping=mapping, enable_loop_closing=False)
    secs = []
    for i in range(n_frames):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam.track_rgbd(imgs[i], deps[i], timestamp=i / 30.0)
        secs.append(time.perf_counter() - t0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return slam, seq, secs


def check_main_path(device) -> dict:
    from orbslam2_tpu_torch import evaluation, kernels

    cfg = bench_config()
    kernels.launch_counts.update(hamming=0, pose_gn=0)
    slam, seq, secs = run_session(cfg, N_FRAMES, device)
    steady_ms = 1000 * np.asarray(secs[TIMED_FROM:])
    launches = dict(kernels.launch_counts)
    ts, poses, tracked = slam.frame_poses()
    if poses.shape != (N_FRAMES, 4, 4) or not np.isfinite(poses).all():
        fail(f"main path: poses of shape {poses.shape}, finite {np.isfinite(poses).all()}")
    ate = evaluation.ate_rmse(poses, seq.poses, align=True)
    n_tracked = int(tracked.sum())
    fps = len(steady_ms) / (steady_ms.sum() / 1000)
    print(f"main path: {n_tracked}/{N_FRAMES} frames tracked, ATE {ate:.5f} m, "
          f"{slam.num_points()} points, {slam.num_keyframes()} keyframe(s)", flush=True)
    print(f"main path: inliers per frame {[r.num_inliers for r in slam.results]}", flush=True)
    print(f"main path: {fps:.2f} frames/s over frames {TIMED_FROM}-{N_FRAMES - 1}; ms/frame "
          f"median {np.median(steady_ms):.2f}, min {steady_ms.min():.2f}, max {steady_ms.max():.2f}",
          flush=True)
    print(f"main path: ms per frame {np.round(1000 * np.asarray(secs), 2).tolist()}", flush=True)
    steady = N_FRAMES - 1  # frame 0 initialises the map
    print(f"main path: launches {launches} over {steady} tracked frames after initialization",
          flush=True)
    if n_tracked != N_FRAMES:
        fail(f"main path lost {N_FRAMES - n_tracked} frames")
    if not ate < ATE_LIMIT_M:
        fail(f"main path ATE {ate} >= {ATE_LIMIT_M}")
    for name, n in launches.items():
        if n < 3 * steady:
            fail(f"main path launched {name} {n} times, fewer than 3 per frame")
    return {"launches": launches, "ate_m": ate, "fps": fps}


def pose_gaps(pa, pb):
    """Per-frame translation (m) and rotation (deg) between two pose lists."""
    dt = np.linalg.norm(pa[:, :3, 3] - pb[:, :3, 3], axis=1)
    R = np.einsum("nji,njk->nik", pa[:, :3, :3], pb[:, :3, :3])
    deg = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    return dt, deg


def check_small_cpu_agreement(device) -> None:
    cfg = small_config()
    gpu, _, _ = run_session(cfg, 6, device)
    cpu, _, _ = run_session(cfg, 6, torch.device("cpu"))
    _, pg, tg = gpu.frame_poses()
    _, pc, tc = cpu.frame_poses()
    dt, deg = pose_gaps(pg, pc)
    print(f"small session, card vs CPU: tracked {int(tg.sum())}/{int(tc.sum())} of 6, "
          f"max dt {dt.max():.3e} m, max rot {deg.max():.3e} deg", flush=True)
    if not (tg.all() and tc.all() and dt.max() < SMALL_DT_M and deg.max() < SMALL_DEG):
        fail("the card and the CPU disagree on the small session")


class KeyframeProbe:
    """Wraps the keyframe stages of `fused` / `local_mapping` for one
    session: K1 launches inside each keyframe step, the local-BA runs and
    the union-fuse row counts. Only counts the wrappers already keep are
    read; nothing is launched here."""

    def __init__(self):
        from orbslam2_tpu_torch import kernels
        from orbslam2_tpu_torch.pipeline import fused
        from orbslam2_tpu_torch.pipeline import local_mapping as lm

        self.k1_per_step, self.ba_runs, self.union_rows = [], 0, []
        self._saved = [(fused, "keyframe_full_step"), (fused, "local_ba_step"),
                       (lm, "fuse_points_into_kf")]
        self._orig = [getattr(m, n) for m, n in self._saved]
        kf_step, ba_step, fuse_into = self._orig

        def keyframe_full_step(*a, **k):
            before = kernels.launch_counts["hamming"]
            out = kf_step(*a, **k)
            self.k1_per_step.append(kernels.launch_counts["hamming"] - before)
            return out

        def local_ba_step(*a, **k):
            self.ba_runs += 1
            return ba_step(*a, **k)

        def fuse_points_into_kf(state, point_ids, *a, **k):
            self.union_rows.append(int(point_ids.shape[0]))
            return fuse_into(state, point_ids, *a, **k)

        for (m, n), f in zip(self._saved, (keyframe_full_step, local_ba_step,
                                           fuse_points_into_kf)):
            setattr(m, n, f)

    def close(self):
        for (m, n), f in zip(self._saved, self._orig):
            setattr(m, n, f)


def check_mapping_path(device) -> dict:
    from orbslam2_tpu_torch import evaluation, kernels

    cfg = bench_config()
    probe = KeyframeProbe()
    try:
        kernels.launch_counts.update(hamming=0, pose_gn=0)
        slam, seq, secs = run_session(cfg, MAP_FRAMES, device, mapping=True)
        launches = dict(kernels.launch_counts)
    finally:
        probe.close()
    ts, poses, tracked = slam.frame_poses()
    if poses.shape != (MAP_FRAMES, 4, 4) or not np.isfinite(poses).all():
        fail(f"mapping path: poses of shape {poses.shape}, finite {np.isfinite(poses).all()}")
    ate = evaluation.ate_rmse(poses, seq.poses, align=True)
    n_tracked = int(tracked.sum())
    kf_frames = [i for i, r in enumerate(slam.results) if r.is_keyframe]
    ms_all = 1000 * np.asarray(secs)
    steady = np.arange(TIMED_FROM, MAP_FRAMES)
    is_kf = np.isin(steady, kf_frames)
    fps = len(steady) / (ms_all[steady].sum() / 1000)
    print(f"mapping path: {n_tracked}/{MAP_FRAMES} frames tracked, ATE {ate:.5f} m, "
          f"{slam.num_points()} points, {len(kf_frames)} keyframes made at frames {kf_frames}, "
          f"{slam.num_keyframes()} live", flush=True)
    print(f"mapping path: local BA on {probe.ba_runs} keyframes; K1 launches per keyframe step "
          f"{probe.k1_per_step}; union-fuse rows {probe.union_rows}", flush=True)
    print(f"mapping path: {fps:.2f} frames/s over frames {TIMED_FROM}-{MAP_FRAMES - 1}; "
          f"ms/frame median {np.median(ms_all[steady]):.2f}; keyframe frames median "
          f"{np.median(ms_all[steady][is_kf]):.2f} ({int(is_kf.sum())}), other frames median "
          f"{np.median(ms_all[steady][~is_kf]):.2f} ({int((~is_kf).sum())})", flush=True)
    print(f"mapping path: ms per frame {np.round(ms_all, 2).tolist()}", flush=True)
    print(f"mapping path: launches {launches} over {MAP_FRAMES - 1} frames after initialization",
          flush=True)
    if n_tracked != MAP_FRAMES:
        fail(f"mapping path lost {MAP_FRAMES - n_tracked} frames")
    if not ate < MAP_ATE_LIMIT_M:
        fail(f"mapping path ATE {ate} >= {MAP_ATE_LIMIT_M}")
    if not MAP_KF_RANGE[0] <= len(kf_frames) <= MAP_KF_RANGE[1]:
        fail(f"mapping path made {len(kf_frames)} keyframes, outside {MAP_KF_RANGE}")
    if slam.num_points() <= MAP_MIN_POINTS:
        fail(f"mapping path ended with {slam.num_points()} points")
    if probe.ba_runs < MAP_MIN_BA:
        fail(f"local BA ran on {probe.ba_runs} keyframes")
    if len(probe.k1_per_step) != len(kf_frames) - 1 or min(probe.k1_per_step) < 1:
        fail(f"K1 launches per keyframe step {probe.k1_per_step}")
    for name, n in launches.items():
        if n < 3 * (MAP_FRAMES - 1):
            fail(f"mapping path launched {name} {n} times, fewer than 3 per frame")
    return {"launches": launches, "ate_m": ate, "fps": fps,
            "union_rows": int(np.median(probe.union_rows)), "slots": cfg.orb.feature_slots}


def time_union_fuse_k1(device, rows: int, slots: int) -> dict:
    """K1 against its plain version at the union-fuse shape the keyframe
    steps launched (the median row count): exact, and both timed."""
    from orbslam2_tpu_torch.ops import cuda_hamming, hamming

    rng = np.random.default_rng(1)
    a, b = rand_desc(rng, rows, device), rand_desc(rng, slots, device)
    got = cuda_hamming.distance_matrix_cuda(a, b)
    if not torch.equal(got, hamming.distance_matrix(a, b)):
        fail(f"K1 {rows}x{slots} differs from the plain version")
    k = time_ms(lambda: cuda_hamming.distance_matrix_cuda(a, b))
    p = time_ms(lambda: hamming.distance_matrix(a, b))
    print(f"K1 {rows}x{slots} (union fuse): exact; kernel {k:.4f} ms, plain {p:.4f} ms "
          f"(median of 20)", flush=True)
    return {"shape_union_fuse": f"{rows}x{slots}", "ms_union_fuse": k, "plain_ms_union_fuse": p}


def check_small_mapping_cpu_agreement(device) -> None:
    cfg = small_config()
    gpu, _, _ = run_session(cfg, SMALL_MAP_FRAMES, device, mapping=True)
    cpu, _, _ = run_session(cfg, SMALL_MAP_FRAMES, torch.device("cpu"), mapping=True)
    kg = [i for i, r in enumerate(gpu.results) if r.is_keyframe]
    kc = [i for i, r in enumerate(cpu.results) if r.is_keyframe]
    _, pg, tg = gpu.frame_poses()
    _, pc, tc = cpu.frame_poses()
    dt, deg = pose_gaps(pg, pc)
    print(f"small mapping session, card vs CPU: keyframes {kg} / {kc}, points "
          f"{gpu.num_points()} / {cpu.num_points()}, tracked {int(tg.sum())}/{int(tc.sum())} of "
          f"{SMALL_MAP_FRAMES}, max dt {dt.max():.3e} m, max rot {deg.max():.3e} deg", flush=True)
    if not (kg == kc == SMALL_MAP_KFS and tg.all() and tc.all()
            and dt.max() < SMALL_DT_M and deg.max() < SMALL_DEG):
        fail("the card and the CPU disagree on the small mapping session")


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        sys.exit(2)
    from orbslam2_tpu_torch import kernels

    device = torch.device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds:.2f} s)", flush=True)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}", flush=True)

    k1 = check_k1(device)
    k2 = check_k2(device)
    main_path = check_main_path(device)
    check_small_cpu_agreement(device)
    mapping = check_mapping_path(device)
    k1.update(time_union_fuse_k1(device, mapping["union_rows"], mapping["slots"]))
    check_small_mapping_cpu_agreement(device)

    if "jax" in sys.modules:
        fail("jax was imported")
    k1["launches"] = main_path["launches"]["hamming"] + mapping["launches"]["hamming"]
    k2["launches"] = main_path["launches"]["pose_gn"] + mapping["launches"]["pose_gn"]
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
