"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile the hand-written kernels (`orbslam2_tpu_torch/csrc`);
3. K1 (Hamming distance) on the card against its plain PyTorch version,
   exact, and both timed with CUDA events;
4. K2 (pose Gauss-Newton) on the card against its plain version, Tcw to
   atol 1e-4 and equal inlier sets, at the RGB-D and stereo paths' 1024
   slots with part of the observations stereo and at the mono path's 1280
   slots with all of them 2-D, and both timed at each;
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
   poses within 5 mm and 0.2 degrees;
9. the stereo path: `System.track_stereo` over the 72 frames at bench.py's
   configuration with `sensor=STEREO`, mapping on. All 72 frames tracked,
   ATE < 0.01 m, 16-26 keyframes, more than 2000 points, exactly one K1
   launch inside every stereo match and one stereo match per frame;
10. the monocular path: `System.track_monocular` over 24 frames of the
   lateral sequence at bench.py's mono configuration (1200 features, 1280
   slots). Initialization by frame 6, every later frame tracked, scaled
   ATE < 0.03 m, at least 3 keyframes, more than 300 points, K1 launched
   inside every initialization search; K1 is then timed at that search's
   shape;
11. the stereo session at 320x240 (18 frames) and the first 16 frames of
   the monocular path on the card and on the CPU: the same keyframes (and
   the same initialization frame), per-frame poses within 5 mm and 0.2
   degrees. The monocular RANSAC draws come from one CPU generator, so
   both solve the same minimal sets.

The launch counts are set to 0 just before each path is driven and read
just after; the kernels line sums the four paths. The last two lines are
a JSON object of the kernels' launch counts, errors and times, and the
JSON result line. Exits non-zero, printing no result, when no CUDA device
is available.
"""

from __future__ import annotations

import dataclasses
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
STEREO_ATE_LIMIT_M = 0.01  # the reference on the CPU gives 0.00402 m here
STEREO_KF_RANGE = (16, 26)  # the reference makes 21 keyframes
MONO_FRAMES = 24           # bench.py --all-sensors' mono segment
MONO_INIT_BY = 6           # the reference initialises at frame 4
MONO_ATE_LIMIT = 0.03      # scaled; the reference on the CPU gives 0.00735 m
MONO_MIN_KFS, MONO_MIN_POINTS = 3, 300   # the reference: 3 and 727
SMALL_MONO_FRAMES = 16


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
    # (slots, real observations, outliers, share with a right coordinate):
    # the RGB-D and stereo paths' 1024 slots, a partly filled frame, a
    # sparser stereo frame, and the mono path's 1280 slots, all 2-D
    problems = [(1024, 700, 80, 0.6), (700, 600, 40, 0.6), (1024, 700, 80, 0.3),
                (1280, 900, 80, 0.0)]
    for n, n_real, n_out, stereo_frac in problems:
        obs = make_pose_problem(rng, device, n=n, n_real=n_real, n_out=n_out,
                                stereo_frac=stereo_frac)
        for rounds, iters in [(2, 6), (3, 6), (4, 6), (4, 10)]:
            got = cuda_pose_opt.pose_optimize_cuda(T0, obs, K, rounds=rounds, iters=iters)
            ref = pose_opt.pose_optimize(T0, obs, K, rounds=rounds, iters=iters)
            torch.cuda.synchronize()
            err = float((got.Tcw - ref.Tcw).abs().max())
            same = torch.equal(got.inliers, ref.inliers)
            chi2_err = float((got.chi2 - ref.chi2)[obs.mask].abs().max())
            label = f"K2 N={n} stereo {stereo_frac:.0%} {rounds}x{iters}"
            print(f"{label}: Tcw max err {err:.3e}, inliers equal {same}"
                  f" ({int(got.num_inliers)}), chi2 max err {chi2_err:.3e}", flush=True)
            if not (err <= TOL_K2_TCW and same):
                fail(f"{label} disagrees with the plain version")
            worst = max(worst, err)
    timed = {}
    for n, n_real, stereo_frac in [(1024, 700, 0.6), (1280, 900, 0.0)]:
        obs = make_pose_problem(np.random.default_rng(1), device, n=n, n_real=n_real,
                                stereo_frac=stereo_frac)
        k = time_ms(lambda: cuda_pose_opt.pose_optimize_cuda(T0, obs, K, rounds=4, iters=6))
        p = time_ms(lambda: pose_opt.pose_optimize(T0, obs, K, rounds=4, iters=6))
        timed[n] = (k, p)
        print(f"K2 N={n} stereo {stereo_frac:.0%} 4x6: kernel {k:.4f} ms, plain {p:.4f} ms "
              f"(median of 20)", flush=True)
    k, p = timed[1024]
    return {"name": "pose_gn", "route": "cuda",
            "source": "orbslam2_tpu_torch/csrc/pose_gn.cu",
            "replaces": "orbslam2_tpu/solvers/pallas_pose_opt.py:242",
            "max_abs_err": worst, "ms": k, "plain_ms": p, "shape": "N=1024, 4x6",
            "ms_mono_1280": timed[1280][0], "plain_ms_mono_1280": timed[1280][1]}


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


def mono_config():
    """bench.py --all-sensors' monocular configuration, synchronous."""
    from orbslam2_tpu_torch import config as c

    cfg = bench_config()
    return dataclasses.replace(
        cfg, sensor=c.Sensor.MONOCULAR,
        orb=dataclasses.replace(cfg.orb, num_features=1200, feature_slots=1280,
                                candidates_per_level=4096),
        tracking=dataclasses.replace(cfg.tracking, th_depth=100.0, mono_init_min_matches=50,
                                     kf_min_gap=2),
    )


def stereo_config(cfg):
    from orbslam2_tpu_torch import config as c

    return dataclasses.replace(cfg, sensor=c.Sensor.STEREO)


def run_session(cfg, n_frames: int, device, mapping: bool = False):
    """Drive the System entry point of `cfg.sensor` (track_rgbd,
    track_stereo or track_monocular) over the forward dolly (the lateral
    sequence for mono), with the frames staged on `device` first. Returns
    (slam, seq, per-frame seconds); each frame ends in a host read of its
    pose, so its time is complete."""
    from orbslam2_tpu_torch import config as c
    from orbslam2_tpu_torch import synthetic
    from orbslam2_tpu_torch.pipeline.system import System

    kind = "lateral" if cfg.sensor == c.Sensor.MONOCULAR else "forward"
    seq = synthetic.textured_sequence(n_frames=n_frames, kind=kind, seed=0, cam=cfg.camera)
    if cfg.sensor == c.Sensor.STEREO:
        frames = [seq.stereo(i)[:2] for i in range(n_frames)]
    else:
        frames = [seq.frame(i) for i in range(n_frames)]
    a = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    b = torch.from_numpy(np.stack([f[1] for f in frames])).to(device)
    slam = System(cfg, device=device, enable_mapping=mapping, enable_loop_closing=False)
    track = {c.Sensor.RGBD: slam.track_rgbd, c.Sensor.STEREO: slam.track_stereo,
             c.Sensor.MONOCULAR: lambda img, _, timestamp: slam.track_monocular(img, timestamp)}
    step = track[cfg.sensor]
    secs = []
    for i in range(n_frames):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(a[i], b[i], timestamp=i / 30.0)
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


class K1Probe:
    """Wraps `module.name` for one session and records the K1 launches
    inside each call and, when `arg` is given, the row count of that
    positional argument; launches nothing itself."""

    def __init__(self, module, name: str, arg: int | None = None):
        from orbslam2_tpu_torch import kernels

        self.per_call, self.rows = [], []
        self._module, self._name = module, name
        self._orig = orig = getattr(module, name)

        def wrapped(*a, **k):
            before = kernels.launch_counts["hamming"]
            out = orig(*a, **k)
            self.per_call.append(kernels.launch_counts["hamming"] - before)
            if arg is not None:
                self.rows.append(int(a[arg].shape[0]))
            return out

        setattr(module, name, wrapped)

    def close(self):
        setattr(self._module, self._name, self._orig)


class KeyframeProbe:
    """Wraps the keyframe stages of `fused` / `local_mapping` for one
    session: K1 launches inside each keyframe step, the local-BA runs and
    the union-fuse row counts. Only counts the wrappers already keep are
    read; nothing is launched here."""

    def __init__(self):
        from orbslam2_tpu_torch.pipeline import fused
        from orbslam2_tpu_torch.pipeline import local_mapping as lm

        self.kf_step = K1Probe(fused, "keyframe_full_step")
        self.union = K1Probe(lm, "fuse_points_into_kf", arg=1)
        self.ba_runs = 0
        self._ba = ba_step = fused.local_ba_step

        def local_ba_step(*a, **k):
            self.ba_runs += 1
            return ba_step(*a, **k)

        fused.local_ba_step = local_ba_step

    @property
    def k1_per_step(self) -> list[int]:
        return self.kf_step.per_call

    @property
    def union_rows(self) -> list[int]:
        return self.union.rows

    def close(self):
        from orbslam2_tpu_torch.pipeline import fused

        fused.local_ba_step = self._ba
        self.kf_step.close()
        self.union.close()


def keyframe_frames(slam) -> list[int]:
    return [i for i, r in enumerate(slam.results) if r.is_keyframe]


def print_rates(label: str, secs, kf_frames) -> float:
    """Print frames/s over frames TIMED_FROM.. and the median ms of
    keyframe frames and other frames apart; returns the frames/s."""
    ms_all = 1000 * np.asarray(secs)
    steady = np.arange(TIMED_FROM, len(secs))
    is_kf = np.isin(steady, kf_frames)
    fps = len(steady) / (ms_all[steady].sum() / 1000)

    def med(sel):
        return f"{np.median(ms_all[steady][sel]):.2f}" if sel.any() else "n/a"

    print(f"{label}: {fps:.2f} frames/s over frames {TIMED_FROM}-{len(secs) - 1}; "
          f"ms/frame median {np.median(ms_all[steady]):.2f}; keyframe frames median "
          f"{med(is_kf)} ({int(is_kf.sum())}), other frames median "
          f"{med(~is_kf)} ({int((~is_kf).sum())})", flush=True)
    print(f"{label}: ms per frame {np.round(ms_all, 2).tolist()}", flush=True)
    return fps


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
    kf_frames = keyframe_frames(slam)
    print(f"mapping path: {n_tracked}/{MAP_FRAMES} frames tracked, ATE {ate:.5f} m, "
          f"{slam.num_points()} points, {len(kf_frames)} keyframes made at frames {kf_frames}, "
          f"{slam.num_keyframes()} live", flush=True)
    print(f"mapping path: local BA on {probe.ba_runs} keyframes; K1 launches per keyframe step "
          f"{probe.k1_per_step}; union-fuse rows {probe.union_rows}", flush=True)
    fps = print_rates("mapping path", secs, kf_frames)
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


def time_k1_at(device, rows: int, cols: int, label: str) -> dict:
    """K1 against its plain version at a shape a path launched: exact, and
    both timed."""
    from orbslam2_tpu_torch.ops import cuda_hamming, hamming

    rng = np.random.default_rng(1)
    a, b = rand_desc(rng, rows, device), rand_desc(rng, cols, device)
    got = cuda_hamming.distance_matrix_cuda(a, b)
    if not torch.equal(got, hamming.distance_matrix(a, b)):
        fail(f"K1 {rows}x{cols} differs from the plain version")
    k = time_ms(lambda: cuda_hamming.distance_matrix_cuda(a, b))
    p = time_ms(lambda: hamming.distance_matrix(a, b))
    print(f"K1 {rows}x{cols} ({label.replace('_', ' ')}): exact; kernel {k:.4f} ms, "
          f"plain {p:.4f} ms (median of 20)", flush=True)
    return {f"shape_{label}": f"{rows}x{cols}", f"ms_{label}": k, f"plain_ms_{label}": p}


def check_stereo_path(device) -> dict:
    from orbslam2_tpu_torch import evaluation, kernels
    from orbslam2_tpu_torch.ops import stereo

    cfg = stereo_config(bench_config())
    probe = K1Probe(stereo, "compute_stereo_matches")
    try:
        kernels.launch_counts.update(hamming=0, pose_gn=0)
        slam, seq, secs = run_session(cfg, MAP_FRAMES, device, mapping=True)
        launches = dict(kernels.launch_counts)
    finally:
        probe.close()
    _, poses, tracked = slam.frame_poses()
    if poses.shape != (MAP_FRAMES, 4, 4) or not np.isfinite(poses).all():
        fail(f"stereo path: poses of shape {poses.shape}, finite {np.isfinite(poses).all()}")
    ate = evaluation.ate_rmse(poses, seq.poses, align=True)
    n_tracked = int(tracked.sum())
    kf_frames = keyframe_frames(slam)
    print(f"stereo path: {n_tracked}/{MAP_FRAMES} frames tracked, ATE {ate:.5f} m, "
          f"{slam.num_points()} points, {len(kf_frames)} keyframes made at frames {kf_frames}, "
          f"{slam.num_keyframes()} live", flush=True)
    last = slam.tracker.last_frame
    share = float(((last.ur >= 0) & last.valid).sum()) / max(int(last.valid.sum()), 1)
    print(f"stereo path: {len(probe.per_call)} stereo matches, K1 launches in each "
          f"{sorted(set(probe.per_call))}; {share:.1%} of the last frame's features matched "
          f"right (K2's stereo share)", flush=True)
    fps = print_rates("stereo path", secs, kf_frames)
    print(f"stereo path: launches {launches} over {MAP_FRAMES - 1} frames after initialization",
          flush=True)
    if n_tracked != MAP_FRAMES:
        fail(f"stereo path lost {MAP_FRAMES - n_tracked} frames")
    if not ate < STEREO_ATE_LIMIT_M:
        fail(f"stereo path ATE {ate} >= {STEREO_ATE_LIMIT_M}")
    if not STEREO_KF_RANGE[0] <= len(kf_frames) <= STEREO_KF_RANGE[1]:
        fail(f"stereo path made {len(kf_frames)} keyframes, outside {STEREO_KF_RANGE}")
    if slam.num_points() <= MAP_MIN_POINTS:
        fail(f"stereo path ended with {slam.num_points()} points")
    if len(probe.per_call) != MAP_FRAMES or set(probe.per_call) != {1}:
        fail(f"stereo path: K1 launches per stereo match {probe.per_call}")
    if launches["pose_gn"] < 3 * (MAP_FRAMES - 1):
        fail(f"stereo path launched pose_gn {launches['pose_gn']} times, fewer than 3 per frame")
    return {"launches": launches, "ate_m": ate, "fps": fps}


def first_tracked(tracked) -> int:
    return int(np.argmax(tracked)) if tracked.any() else len(tracked)


def check_mono_path(device) -> dict:
    from orbslam2_tpu_torch import evaluation, kernels
    from orbslam2_tpu_torch.ops import match

    cfg = mono_config()
    probe = K1Probe(match, "search_for_initialization", arg=0)
    try:
        kernels.launch_counts.update(hamming=0, pose_gn=0)
        slam, seq, secs = run_session(cfg, MONO_FRAMES, device, mapping=True)
        launches = dict(kernels.launch_counts)
    finally:
        probe.close()
    _, poses, tracked = slam.frame_poses()
    if poses.shape != (MONO_FRAMES, 4, 4) or not np.isfinite(poses).all():
        fail(f"mono path: poses of shape {poses.shape}, finite {np.isfinite(poses).all()}")
    init = first_tracked(tracked)
    ate = (evaluation.ate_rmse(poses[tracked], seq.poses[tracked], align=True, with_scale=True)
           if tracked.sum() >= 3 else float("inf"))
    kf_frames = keyframe_frames(slam)
    print(f"mono path: initialised at frame {init}, {int(tracked.sum())}/{MONO_FRAMES} frames "
          f"tracked, scaled ATE {ate:.5f}, {slam.num_points()} points, {slam.num_keyframes()} "
          f"keyframes (made at frames {kf_frames})", flush=True)
    print(f"mono path: {len(probe.per_call)} initialization searches, K1 launches in each "
          f"{probe.per_call}", flush=True)
    fps = print_rates("mono path", secs, kf_frames)
    print(f"mono path: launches {launches}", flush=True)
    if init > MONO_INIT_BY or not tracked[init:].all():
        fail(f"mono path: initialised at frame {init}, tracked {tracked.astype(int).tolist()}")
    if not ate < MONO_ATE_LIMIT:
        fail(f"mono path scaled ATE {ate} >= {MONO_ATE_LIMIT}")
    if slam.num_keyframes() < MONO_MIN_KFS or slam.num_points() <= MONO_MIN_POINTS:
        fail(f"mono path: {slam.num_keyframes()} keyframes, {slam.num_points()} points")
    if not probe.per_call or min(probe.per_call) < 1:
        fail(f"mono path: K1 launches per initialization search {probe.per_call}")
    if launches["pose_gn"] < 3 * (MONO_FRAMES - init - 1):
        fail(f"mono path launched pose_gn {launches['pose_gn']} times, fewer than 3 per frame")
    return {"launches": launches, "ate": ate, "fps": fps, "search_rows": probe.rows[-1],
            "slots": cfg.orb.feature_slots}


def check_small_cpu_agreement(device, cfg, n_frames: int, label: str, mapping: bool = True,
                              expect_kfs=None) -> None:
    """One session on the card and on the CPU: the same initialization
    frame and keyframes (`expect_kfs` when given), every frame after the
    initialization tracked, per-frame poses within 5 mm and 0.2 degrees."""
    gpu, _, _ = run_session(cfg, n_frames, device, mapping=mapping)
    cpu, _, _ = run_session(cfg, n_frames, torch.device("cpu"), mapping=mapping)
    kg, kc = keyframe_frames(gpu), keyframe_frames(cpu)
    _, pg, tg = gpu.frame_poses()
    _, pc, tc = cpu.frame_poses()
    both = tg & tc
    dt, deg = pose_gaps(pg[both], pc[both])
    print(f"{label}, card vs CPU: initialised at frame {first_tracked(tg)} / {first_tracked(tc)}, "
          f"keyframes {kg} / {kc}, points {gpu.num_points()} / {cpu.num_points()}, tracked "
          f"{int(tg.sum())}/{int(tc.sum())} of {n_frames}, max dt {dt.max():.3e}, "
          f"max rot {deg.max():.3e} deg", flush=True)
    if not (kg == kc and (expect_kfs is None or kg == expect_kfs) and np.array_equal(tg, tc)
            and tg[first_tracked(tg):].all() and dt.max() < SMALL_DT_M and deg.max() < SMALL_DEG):
        fail(f"the card and the CPU disagree on the {label}")


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

    t_start = t0 = time.perf_counter()
    kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds:.2f} s)", flush=True)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}", flush=True)

    k1 = check_k1(device)
    k2 = check_k2(device)
    main_path = check_main_path(device)
    check_small_cpu_agreement(device, small_config(), 6, "small session", mapping=False)
    mapping = check_mapping_path(device)
    k1.update(time_k1_at(device, mapping["union_rows"], mapping["slots"], "union_fuse"))
    check_small_cpu_agreement(device, small_config(), SMALL_MAP_FRAMES, "small mapping session",
                              expect_kfs=SMALL_MAP_KFS)
    stereo_path = check_stereo_path(device)
    mono_path = check_mono_path(device)
    k1.update(time_k1_at(device, mono_path["search_rows"], mono_path["slots"], "mono_search"))
    check_small_cpu_agreement(device, stereo_config(small_config()), SMALL_MAP_FRAMES,
                              "small stereo session")
    check_small_cpu_agreement(device, mono_config(), SMALL_MONO_FRAMES, "small mono session")

    if "jax" in sys.modules:
        fail("jax was imported")
    paths = (main_path, mapping, stereo_path, mono_path)
    k1["launches"] = sum(p["launches"]["hamming"] for p in paths)
    k2["launches"] = sum(p["launches"]["pose_gn"] for p in paths)
    print(f"total: {time.perf_counter() - t_start:.1f} s from the build to the last phase",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
