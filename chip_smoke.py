"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile the hand-written kernels (`orbslam2_tpu_torch/csrc`);
3. K1 (Hamming distance) on the card against its plain PyTorch version,
   exact at ragged and empty shapes and on words of all zeros, all ones
   and the sign bit alone; then timed at the tracking shapes and at a
   vocabulary retrain's, the 262144-row reservoir against 256 coarse
   words (exact there too);
4. K2 (pose Gauss-Newton) on the card against its plain version, Tcw to
   atol 1e-4 and equal inlier sets, its `num_inliers` equal to
   `inliers.sum()`, at the RGB-D and stereo paths' 1024 slots with part
   of the observations stereo and at the mono path's 1280 slots with all
   of them 2-D; then timed at both;
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
   both solve the same minimal sets;
12. relocalization (loop closing on, the default, from here on): the first
   34 frames of the dolly at bench.py's configuration, 3 black frames
   (LOST), then frame 10 again until it relocalizes: within 3 frames, with
   a translation error < 0.1 m to frame 10's ground truth, K1 and K2
   launched in the relocalizing frame;
13. the 640x480 orbit, bench.py's segment B (170 orbit frames and a
   35-frame revisit, `th_depth` 130), with bench.py's loop-closer warm-up
   at session start: the reference's first 8 keyframes (as far as the
   card, the port on the CPU and the reference decide alike), no more
   loops closed and frames lost than in the reference's own CPU run
   (`tools/loop_reference_targets.py`), a Sim3 verification in the
   revisit against a keyframe of the orbit's start, K1 in every
   verification; it prints every keyframe's frame, every verification's
   outcome, the warm-up's seconds and the first verification frame's ms;
14. the 320x240 orbit of `test_orbit_loop_closes`: the same checks with
   the reference's keyframes up to its correction, at least one loop
   closed, ATE over the orbit's frames < 0.05 m;
15. the 320x240 dolly with loop closing on (18 frames) and the
   relocalization session at the CPU tests' 640x480 configuration on the
   card and on the CPU: the same keyframes, database rows and
   relocalization frame, the relocalized pose and the small session's
   poses within 1e-5 m (the relocalization session's mapping frames
   within 5e-5 m);
16. localization mode: the mapping path's 72 frames again, loop closing
   on (its database is what relocalization searches), then
   `activate_localization_mode` and `tests/test_system_features.py`'s
   mbVO turn from frame 71's pose (2.5 degrees a frame to 110, 4 frames
   held, back to 0). The visual odometry engages on at least one frame,
   no keyframe is made, K1 is launched in every odometry frame and K2 in
   the frame that relocalizes, and the last frame is out of mbVO within
   0.15 m of its ground truth; it prints the odometry and relocalizing
   frames' ms, the odometry steps that tracked and how far each frame's
   rotation is from orthonormal;
17. a shorter localization session at the 320x240 configuration (10
   mapping frames, the turn to 70 degrees and back in three steps) on the
   card and on the CPU: the same mbVO flags and states per frame, the
   frames tracked on the map within 5 mm and 0.2 degrees, and each
   odometry step of the card within 1e-4 m and 5e-3 degrees of the CPU's
   step from the card's own state, with at least 5 steps tracked;
18. the command-line runner: 40 dolly frames at 640x480 written as a TUM
   RGB-D directory (8-bit RGB PNGs, 16-bit depth at 5000 counts per
   metre, `rgb.txt`, `depth.txt`, `groundtruth.txt`, an ORB-SLAM2 YAML of
   bench.py's camera), then `python -m orbslam2_tpu_torch.run --dataset
   tum ... --viz` in a child process on the card: every frame tracked,
   ATE < 0.01 m, the native decoder in use (else its build error printed
   and the phase failed), the PNG snapshots written;
19. the essential graph's PCG solve at 160 keyframes (past
   `pose_graph_dense_max_k`, 128, where the loop closer switches to it)
   on the card against the CPU, packs within 1e-4 up to each
   quaternion's sign;
20. the multi-device slice and the graft entry points: `graft_entry.entry()`'s
   per-frame function on the card against the port on the CPU, on its
   example arguments and on a rendered frame with map points made from
   its own features (the same inliers, more than 100 on the frame, Tcw
   within 1e-4, at least 99 % of the descriptors equal), K1 and K2
   launched in both calls; then this process as the one rank of an NCCL
   group at bench_scaling.py's sizes: the sharded BA's direct solve equal
   to `bundle_adjust` to the bit over 10 iterations, the PCG solve's first
   step (48 CG steps) within 1e-4 relative of a float64 dense solve of
   the same system and its 10-iteration cost printed beside the direct
   solve's (C=64, P=32768, O=8); both sharded pose-graph modes equal to the
   single-device PCG to the bit (K=256, E=8192, 3 iterations); the sharded
   BoW query equal to `database._query` (K=4096, V=4096); the ms per LM,
   GN and query iteration beside the single-device solvers'; then
   `dryrun_multichip(1)` in a spawned rank, and a second rank refused.
   One card serves one rank: ranks beyond 1 run on the CPU (the tests);
21. the long session's paths: the 320x240 orbit of phase 14 with
   `pose_graph_dense_max_k` 64, below its 96 keyframe slots, so that each
   loop correction solves the essential graph by PCG: the reference's
   keyframes through its correction, no fewer loops closed and no more
   frames lost than the reference's run of that session, every correction
   through `optimize_pose_graph_pcg` (the calls counted by wrapping it)
   and K1 in every verification; then `orbslam2_tpu_torch.scale`'s stages
   at 1024 keyframes and 98304 points on the card, its graph stages again
   on the CPU: the dropped observations, observation tables,
   covisibility and essential edges equal, the pose-graph vertices within
   1e-4 up to each quaternion's sign, the global BA's cost after 2
   iterations finite and below its start; each stage's seconds and the
   peak device bytes printed; last, slot recycling card against CPU: the
   320x240 orbit's first 28 frames through a 7-slot pool, the reference's
   keyframes and culled slots (1, then 2; frame 27's keyframe recycles
   slot 1), the same database rows, poses within 5 mm and 0.2 degrees.

How a kernel is timed, at each shape: `ms` is its device time, 50
launches into preallocated outputs captured in one CUDA graph and the
replay timed with CUDA events (median of 7 replays, divided by 50), so no
host work lies inside the window; `call_ms` is its wrapper's time per call
with CUDA events around each call (the host cost the path pays);
`plain_ms` the plain version's; `library_ms` (K1 only) the device time of
one fp16 `torch.addmm` computing the same distances, a yardstick the port
never calls; `bound_ms` the larger of its bytes over 3.35 TB/s and its
operations over the peak rate of their type.

The launch counts are set to 0 just before each path is driven and read
just after; the kernels line sums the ten paths and gives each path's
counts. The last two lines are that JSON object of the kernels' launch
counts, errors and times, and the JSON result line. Exits non-zero,
printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from orbslam2_tpu_torch import drive

GRAPH_LAUNCHES = 50       # kernel launches captured in one CUDA graph
GRAPH_REPLAYS = 7         # device time: median over replays of replay time / launches
L2_BYTES = 50 * 2**20
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet, at 700 W)
PEAK_INT8_OPS = 1979e12     # dense int8 tensor cores
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
K2_FLOPS_PER_EDGE = 200     # one observation's residual, Jacobian and 27 sums, per iteration
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
RELOC_MAP_FRAMES, RELOC_BLACK, RELOC_REVISIT, RELOC_TRIES = 34, 3, 10, 3
RELOC_ERR_M = 0.1
ORBIT_FRAMES, ORBIT_REVISIT = 170, 35
# the reference's own runs on the CPU, one JAX device, pipeline_depth 0
# (tools/loop_reference_targets.py): loops closed, the frame of each
# correction, frames lost, ATE over the tracked frames, and its first
# keyframes' frames: as far as the card and the port on the CPU make the
# same keyframe decisions (the 640x480 port on the CPU makes its 9th
# keyframe at frame 69, the reference at 70; PERF.md)
ORBIT640_REFERENCE = dict(loops_closed=1, loop_frames=[177], lost=1, ate=5.411249850657415,
                          kf_prefix=[0, 2, 5, 10, 18, 27, 43, 56])
ORBIT320_REFERENCE = dict(loops_closed=1, loop_frames=[173], lost=1, ate=0.18967547984200245,
                          ate_orbit=0.020589229995152405,
                          kf_prefix=[0, 2, 5, 9, 13, 17, 22, 27, 32, 37, 44, 49, 54, 59, 63, 66,
                                     69, 73, 77, 80, 83, 86, 89, 92, 96, 100, 104, 108, 111, 114,
                                     118, 124, 129, 133, 137, 141, 146, 150, 154, 159, 163, 167,
                                     171])
RELOC640_REFERENCE = dict(relocalized_at_try=0, t_err=0.003939959066388856)
ORBIT_ATE_LIMIT_M = 0.05  # the orbit's frames alone; the reference on the CPU gives 0.0206 m (320x240)
LOOP_CPU_DT_M = 1e-5       # the loop-closing session, and the relocalized frame
# the relocalization session's frames before the blackout: tracking and
# local BA at 640x480 drift 1.62e-5 m card against CPU by frame 19
# (measured on an NVIDIA H100 80GB HBM3 at 700 W)
RELOC_CPU_DT_M = 5e-5
# tests/test_system_features.py::test_localization_mbvo_blackout_and_recovery:
# degrees of yaw from the last mapped frame's pose
LOC_YAWS = tuple(float(y) for y in (list(np.arange(2.5, 111, 2.5)) + [110.0] * 4
                                    + list(np.arange(107.5, -0.1, -2.5))))
LOC_ERR_M = 0.15
# the card against the CPU at 320x240: the first 28 frames of that
# schedule (to 70 degrees), where the odometry takes over from coarse
# tracking at 52.5 degrees and tracks seven steps, then back to 60, 50 and
# 40 degrees: it loses the 10-degree steps and relocalization takes over
# at 40. The odometry chain multiplies a pose difference about 2.4-fold a
# frame (its rotations drift off SO(3), ROADMAP queue 3;
# `tools/odometry_sensitivity.py`), so its steps are held one at a time,
# each from the card's own state.
SMALL_LOC_MAP_FRAMES = 10
SMALL_LOC_YAWS = LOC_YAWS[:28] + (60.0, 50.0, 40.0)
# one odometry step, the card against the CPU from the card's state: the
# same matches give the pose to float32 rounding (K2 is within 3.4e-7 of
# its plain version); the bars leave room for one match or inlier decided
# the other way at its gate (~1/150 of a pixel's worth at 3 m). The pose
# compared is the one the step keeps.
VO_STEP_DT_M, VO_STEP_DEG, VO_STEP_INLIERS = 1e-4, 5e-3, 2
VO_MIN_STEPS = 5
CLI_FRAMES = 40
CLI_ATE_LIMIT_M = 0.01
PCG_KEYFRAMES = 160        # past the loop closer's pose_graph_dense_max_k (128)
TOL_PCG = 1e-4
# a vocabulary retrain's K1 shape: the reservoir (reservoir_cap 262144 in
# the long run) against the two-level codebook's 256 coarse words
RESERVOIR_K1 = (262144, 256)
# phase 21: the 320x240 orbit with the essential graph's dense solve
# capped below its 96 keyframe slots, so every correction takes the PCG;
# the reference's own run of it (tools/loop_reference_targets.py
# orbit320_pcg, CPU, one device). Its keyframes before the correction are
# the 320x240 orbit's (the cap changes nothing before it).
ORBIT320_PCG_DENSE_MAX_K = 64
ORBIT320_PCG_REFERENCE = dict(loops_closed=1, loop_frames=[173], lost=1, ate=2.4750579503916805,
                              ate_orbit=0.015863539123523614,
                              kf_prefix=ORBIT320_REFERENCE["kf_prefix"])
# phase 21: stress_scale.py's map (orbslam2_tpu_torch.scale)
SCALE_SHAPE = (1024, 98304)
# phase 21: the 320x240 orbit's first 28 frames through a 7-slot pool, as
# tests/test_torch_longrun.py runs it against the reference: its keyframes,
# and the slots it culls (slot 1 is recycled by frame 27's keyframe)
RECYCLE_SLOTS, RECYCLE_FRAMES = 7, 28
RECYCLE_KFS, RECYCLE_CULLED = [0, 2, 5, 9, 13, 17, 22, 27], [1, 2]
# the multi-device slice at bench_scaling.py's sizes: BA (C, P, O), pose
# graph (K, E), BoW database (K, V)
SHARD_BA_SHAPE, SHARD_PG_SHAPE, SHARD_BOW_SHAPE = (64, 32768, 8), (256, 8192), (4096, 4096)
SHARD_BA_ITERS, SHARD_PG_ITERS, SHARD_CG = 10, 3, 48
TOL_PCG_STEP = 1e-4        # the PCG camera solve against a float64 dense solve
# graft entry, card against CPU; the descriptor share is test_torch_orb.py's bar
GRAFT_TCW_TOL, GRAFT_DESC_SHARE, GRAFT_MIN_INLIERS = 1e-4, 0.99, 100


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def call_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one call of `fn` (the wrapper: its checks,
    allocations and launches, host enqueue included) over `reps` calls,
    CUDA events around each, after one warm-up call. On an idle card the
    device waits inside the window for the host, so this is the cost the
    host-bound path pays per call, not the kernel's device time."""
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


def device_ms(launch) -> float:
    """Device milliseconds of one launch: GRAPH_LAUNCHES calls of
    `launch(i)` captured in one CUDA graph, the graph's replay timed with
    CUDA events and divided by the launch count, median of GRAPH_REPLAYS
    replays. The host enqueues nothing inside the window. `launch(i)`
    writes into preallocated outputs (large ones cycled by `i`, see
    `copies`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(0)  # lazy initialisation (cuBLAS workspace) off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(GRAPH_LAUNCHES):
            launch(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    return statistics.median(times)


def copies(out_bytes: int) -> int:
    """Output buffers to cycle through so that one graph's launches write
    at least twice the L2 cache: the stores then reach device memory, as
    the bound assumes, rather than stay in L2."""
    return max(1, min(GRAPH_LAUNCHES, -(-2 * L2_BYTES // max(out_bytes, 1))))


def bound_ms(n_bytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rand_desc(rng, n: int, device) -> torch.Tensor:
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def edge_descs(rng, n: int, device) -> torch.Tensor:
    """Random descriptors whose first rows are the words a ±1 expansion
    could get wrong: all zeros, all ones, only the sign bit, all but the
    sign bit, only bit 0."""
    d = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    for i, w in enumerate([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1][:n]):
        d[i] = w
    return torch.from_numpy(d.view(np.int32)).to(device)


def pm1_fp16(d: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 words -> [N, 256] fp16 ±1 (bit j of word w at column
    32 w + j): the operand of `distance_matrix_mxu`'s formulation."""
    shifts = torch.arange(32, device=d.device, dtype=torch.int32)
    bits = (d[:, :, None] >> shifts) & 1
    return (2 * bits - 1).reshape(d.shape[0], 256).to(torch.float16)


def time_k1(a, b, label: str) -> dict:
    """K1 at one shape: exact against its plain version and the library
    yardstick; then its device time, its wrapper's time per call, the
    plain version's time, the yardstick's device time and the bound."""
    from orbslam2_tpu_torch.ops import cuda_hamming, hamming

    n, m = a.shape[0], b.shape[0]
    got = cuda_hamming.distance_matrix_cuda(a, b)
    if not torch.equal(got, hamming.distance_matrix(a, b)):
        fail(f"K1 {n}x{m} differs from the plain version")
    # yardstick: d = 128 - <sa, sb> / 2 as one fp16 addmm on the tensor
    # cores, exact since every value is an integer of at most 256
    sa, sb_t = pm1_fp16(a), pm1_fp16(b).t().contiguous()
    bias = torch.full((1, m), 128.0, dtype=torch.float16, device=a.device)
    if not torch.equal(torch.addmm(bias, sa, sb_t, alpha=-0.5).to(torch.int32), got):
        fail(f"K1 {n}x{m}: the fp16 addmm yardstick differs from the kernel")
    outs = [torch.empty((n, m), dtype=torch.int32, device=a.device)
            for _ in range(copies(4 * n * m))]
    ms = device_ms(lambda i: cuda_hamming.launch(a, b, outs[i % len(outs)]))
    outs = [torch.empty((n, m), dtype=torch.float16, device=a.device)
            for _ in range(copies(2 * n * m))]
    lib_ms = device_ms(lambda i: torch.addmm(bias, sa, sb_t, alpha=-0.5,
                                             out=outs[i % len(outs)]))
    del outs
    wrapper_ms = call_ms(lambda: cuda_hamming.distance_matrix_cuda(a, b))
    plain_ms = call_ms(lambda: hamming.distance_matrix(a, b))
    bnd, by = bound_ms(32 * (n + m) + 4 * n * m, 2 * 256 * n * m, PEAK_INT8_OPS)
    print(f"K1 {n}x{m} ({label}): exact; device {ms:.5f} ms, wrapper {wrapper_ms:.5f} ms/call, "
          f"plain {plain_ms:.4f} ms, fp16 addmm {lib_ms:.5f} ms, bound {bnd:.5f} ms ({by}), "
          f"{bnd / ms:.1%} of it", flush=True)
    return {"shape": f"{n}x{m}", "ms": ms, "call_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by}


def check_k1(device) -> dict:
    from orbslam2_tpu_torch.ops import cuda_hamming, hamming

    rng = np.random.default_rng(0)
    # ragged edges of the tiles, the empty cases, and the words a ±1
    # expansion could get wrong
    for n, m in [(1, 1), (100, 300), (1023, 1025), (129, 7), (5, 130), (0, 64), (64, 0)]:
        a, b = edge_descs(rng, n, device), edge_descs(rng, m, device)
        got = cuda_hamming.distance_matrix_cuda(a, b)
        ref = hamming.distance_matrix(a, b)
        torch.cuda.synchronize()
        if got.shape != (n, m) or not torch.equal(got, ref):
            fail(f"K1 {n}x{m}: {int((got != ref).sum())} entries differ from the plain version")
        print(f"K1 {n}x{m}: exact", flush=True)
    ones = torch.full((3, 8), -1, dtype=torch.int32, device=device)
    zeros = torch.zeros((2, 8), dtype=torch.int32, device=device)
    d = cuda_hamming.distance_matrix_cuda(torch.cat([ones, zeros]), torch.cat([zeros, ones]))
    want = torch.tensor([[256, 256, 0, 0, 0]] * 3 + [[0, 0, 256, 256, 256]] * 2,
                        dtype=torch.int32, device=device)
    if not torch.equal(d, want):
        fail(f"K1 all ones against all zeros: {d.tolist()}")
    print("K1 all ones / all zeros: distances 256 and 0", flush=True)
    shapes = {}
    for n, m, label in [(1024, 1024, "tracking"), (4096, 1024, "tracking"),
                        (*RESERVOIR_K1, "two-level vocabulary's coarse assignment")]:
        t = time_k1(rand_desc(rng, n, device), rand_desc(rng, m, device), label)
        shapes[t["shape"]] = t
    main = shapes["4096x1024"]
    return {"name": "hamming_distance_matrix", "route": "cuda",
            "source": "orbslam2_tpu_torch/csrc/hamming.cu",
            "replaces": "orbslam2_tpu/ops/pallas_hamming.py:55", "max_abs_err": 0,
            **{k: main[k] for k in ("shape", "ms", "call_ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            "shapes": shapes}


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
            if not (got.num_inliers.dtype == ref.num_inliers.dtype and got.num_inliers.dim() == 0
                    and int(got.num_inliers) == int(got.inliers.sum())):
                fail(f"{label}: num_inliers {got.num_inliers} is not inliers.sum()")
            print(f"{label}: Tcw max err {err:.3e}, inliers equal {same}"
                  f" ({int(got.num_inliers)}), chi2 max err {chi2_err:.3e}", flush=True)
            if not (err <= TOL_K2_TCW and same):
                fail(f"{label} disagrees with the plain version")
            worst = max(worst, err)
    shapes = {}
    for n, n_real, stereo_frac in [(1024, 700, 0.6), (1280, 900, 0.0)]:
        obs = make_pose_problem(np.random.default_rng(1), device, n=n, n_real=n_real,
                                stereo_frac=stereo_frac)
        t = time_k2(T0, obs, K, rounds=4, iters=6)
        t["shape"] = f"N={n}, {stereo_frac:.0%} stereo, 4x6"
        shapes[t["shape"]] = t
        print(f"K2 {t['shape']}: device {t['ms']:.5f} ms, wrapper {t['call_ms']:.5f} ms/call, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']})",
              flush=True)
    main = next(iter(shapes.values()))
    return {"name": "pose_gn", "route": "cuda",
            "source": "orbslam2_tpu_torch/csrc/pose_gn.cu",
            "replaces": "orbslam2_tpu/solvers/pallas_pose_opt.py:242", "max_abs_err": worst,
            **{k: main[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None, "shapes": shapes}


def time_k2(T0, obs, K, rounds: int, iters: int) -> dict:
    """K2 on one problem: its device time, its wrapper's time per call,
    the plain version's time and the bound. No single PyTorch call
    computes the schedule, so there is no library yardstick."""
    from orbslam2_tpu_torch.solvers import cuda_pose_opt, pose_opt

    r = cuda_pose_opt.pose_optimize_cuda(T0, obs, K, rounds=rounds, iters=iters)
    outs = (r.Tcw, r.inliers, r.chi2, r.num_inliers)
    ms = device_ms(lambda i: cuda_pose_opt.launch(T0, obs, K.pinhole, rounds, iters, *outs))
    wrapper_ms = call_ms(lambda: cuda_pose_opt.pose_optimize_cuda(T0, obs, K, rounds, iters))
    plain_ms = call_ms(lambda: pose_opt.pose_optimize(T0, obs, K, rounds, iters))
    n, edges = obs.pw.shape[0], int(obs.mask.sum())
    # each slot's 29 input bytes read once, its inlier flag and chi2
    # written once; every real observation in every iteration
    bnd, by = bound_ms(29 * n + 5 * n, K2_FLOPS_PER_EDGE * edges * rounds * iters,
                       PEAK_FP32_FLOPS)
    return {"ms": ms, "call_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by}


def bench_config(width: int = 640, height: int = 480, features: int = 1000,
                 slots: int = 1024, points: int = 16384, local_points: int = 4096,
                 keyframes: int = 96, ba_points: int = 4096, ba_local: int = 24,
                 ba_fixed: int = 16):
    """bench.py's camera, ORB, map and local-BA sizes and its loop-closing
    and relocalization warm-ups, synchronous."""
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
        # bench.py:104: the correction and relocalization chains run once
        # at session start
        vocab=c.VocabConfig(warmup_correction=True, warmup_reloc=True),
    )


def small_config():
    """The 320x240 / 300-feature configuration of the CPU tests (no
    loop-closer warm-up, as there)."""
    from orbslam2_tpu_torch import config as c

    cfg = bench_config(width=320, height=240, features=300, slots=320, points=8192,
                       local_points=2048, keyframes=32, ba_points=2048, ba_local=16)
    return dataclasses.replace(cfg, vocab=c.VocabConfig())


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


# the render workers (`drive.RenderPool`), started by `start_render_pool`;
# None renders in this process
_POOL = None


def start_render_pool() -> None:
    global _POOL
    _POOL = drive.RenderPool()


def stop_render_pool() -> None:
    global _POOL
    _POOL.close()
    _POOL = None


def render(spec, indices, stereo: bool = False) -> list:
    """Frames `indices` of the sequence of `spec` (`drive.sequence`),
    (image, depth) or (left, right) each, rendered by the worker pool when
    there is one."""
    return (_POOL or drive.RenderPool(0)).render(spec, indices, stereo)


def run_session(cfg, n_frames: int, device, mapping: bool = False, loop_closing: bool = False):
    """Drive the System entry point of `cfg.sensor` (track_rgbd,
    track_stereo or track_monocular) over the forward dolly (the lateral
    sequence for mono), with the frames staged on `device` first. Returns
    (slam, seq, per-frame seconds); each frame ends in a host read of its
    pose, so its time is complete."""
    from orbslam2_tpu_torch import config as c
    from orbslam2_tpu_torch.pipeline.system import System

    kind = "lateral" if cfg.sensor == c.Sensor.MONOCULAR else "forward"
    spec = (n_frames, kind, cfg.camera, 0)
    seq = drive.sequence(spec)
    frames = render(spec, range(n_frames), stereo=cfg.sensor == c.Sensor.STEREO)
    a = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    b = torch.from_numpy(np.stack([f[1] for f in frames])).to(device)
    slam = System(cfg, device=device, enable_mapping=mapping, enable_loop_closing=loop_closing)
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
    return {"launches": launches, "ate_m": ate, "fps": fps, "frames": N_FRAMES}


def nearest_rotation(R: np.ndarray) -> np.ndarray:
    """The rotations nearest to [..., 3, 3] matrices (SVD, float64)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    return U @ Vt


def pose_gaps(pa, pb):
    """Per-frame translation (m) and rotation (deg) between two pose lists.
    The angle is that of R_a^T R_b after each rotation is projected onto
    SO(3): the tracked poses are float32 products that drift off it (by up
    to 5e-4 in the odometry's frames), and the float32 arccos of the
    trace reads that drift as tenths of a degree of rotation. A frame
    whose pose is not finite in either list (a lost odometry frame's
    extrapolation can overflow) gets NaN for both."""
    pa, pb = np.asarray(pa, np.float64), np.asarray(pb, np.float64)
    ok = np.isfinite(pa).all(axis=(1, 2)) & np.isfinite(pb).all(axis=(1, 2))
    dt, deg = np.full(len(pa), np.nan), np.full(len(pa), np.nan)
    dt[ok] = np.linalg.norm(pa[ok, :3, 3] - pb[ok, :3, 3], axis=1)
    R = np.einsum("nji,njk->nik", nearest_rotation(pa[ok, :3, :3]),
                  nearest_rotation(pb[ok, :3, :3]))
    deg[ok] = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
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
    kf_frames = drive.keyframe_frames(slam)
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
    return {"launches": launches, "ate_m": ate, "fps": fps, "frames": MAP_FRAMES,
            "union_rows": int(np.median(probe.union_rows)), "slots": cfg.orb.feature_slots,
            "k1_per_keyframe_step": probe.k1_per_step}


def time_k1_at(device, rows: int, cols: int, label: str) -> dict:
    """K1 at a shape a path launched, as `time_k1`."""
    rng = np.random.default_rng(1)
    return time_k1(rand_desc(rng, rows, device), rand_desc(rng, cols, device), label)


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
    kf_frames = drive.keyframe_frames(slam)
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
    return {"launches": launches, "ate_m": ate, "fps": fps, "frames": MAP_FRAMES,
            "k1_per_stereo_match": sorted(set(probe.per_call))}


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
    kf_frames = drive.keyframe_frames(slam)
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
    return {"launches": launches, "ate": ate, "fps": fps, "frames": MONO_FRAMES,
            "k1_per_init_search": probe.per_call, "search_rows": probe.rows[-1],
            "slots": cfg.orb.feature_slots}


def check_small_cpu_agreement(device, cfg, n_frames: int, label: str, mapping: bool = True,
                              expect_kfs=None) -> None:
    """One session on the card and on the CPU: the same initialization
    frame and keyframes (`expect_kfs` when given), every frame after the
    initialization tracked, per-frame poses within 5 mm and 0.2 degrees."""
    gpu, _, _ = run_session(cfg, n_frames, device, mapping=mapping)
    cpu, _, _ = run_session(cfg, n_frames, torch.device("cpu"), mapping=mapping)
    kg, kc = drive.keyframe_frames(gpu), drive.keyframe_frames(cpu)
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


def reloc_small_config():
    """The CPU tests' `small_cfg` (tests/test_e2e_rgbd.py): 640x480, 600
    features."""
    from orbslam2_tpu_torch import config as c

    return c.SlamConfig(
        sensor=c.Sensor.RGBD,
        camera=c.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0, fps=30.0),
        orb=c.OrbConfig(num_features=600, feature_slots=640, candidates_per_level=2048),
        map=c.MapConfig(max_keyframes=32, max_points=8192, max_local_points=4096),
        tracking=c.TrackingConfig(th_depth=40.0),
    )


def orbit640_config():
    """bench.py's segment B: its configuration with `th_depth` 130."""
    cfg = bench_config()
    return dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, th_depth=130.0))


def orbit320_config():
    """`tests/test_loop_reloc.py::test_orbit_loop_closes`'s configuration."""
    from orbslam2_tpu_torch import config as c

    return c.SlamConfig(
        sensor=c.Sensor.RGBD,
        camera=c.CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, fps=30.0,
                              width=320, height=240),
        orb=c.OrbConfig(num_features=400, feature_slots=512, candidates_per_level=1024),
        map=c.MapConfig(max_keyframes=96, max_points=16384, max_local_points=4096),
        tracking=c.TrackingConfig(th_depth=130.0),
    )


def staged(frames, device):
    a = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    b = torch.from_numpy(np.stack([f[1] for f in frames])).to(device)
    return a, b


def timed_track(slam, a, b, i, secs) -> None:
    """One `track_rgbd` call, its seconds appended to `secs` (it ends in a
    host read of the pose, so the time is complete)."""
    if a.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.track_rgbd(a, b, timestamp=i / 30.0)
    secs.append(time.perf_counter() - t0)


def run_reloc_session(cfg, device):
    """RELOC_MAP_FRAMES frames of the dolly, RELOC_BLACK black frames, then
    frame RELOC_REVISIT until it relocalizes (at most RELOC_TRIES times),
    loop closing on; the tracking state is read where
    `tools/loop_reference_targets.py` reads it, since the read drains the
    loop closer. Returns (slam, seq, per-frame seconds, state before the
    blackout, LOST after it, the try that relocalized or None, the launches
    of each revisit frame)."""
    from orbslam2_tpu_torch import kernels, synthetic
    from orbslam2_tpu_torch.pipeline.system import System
    from orbslam2_tpu_torch.pipeline.tracking import TrackState

    spec = (RELOC_MAP_FRAMES, "forward", cfg.camera, 0)
    seq = drive.sequence(spec)
    black = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    a, b = staged(render(spec, range(RELOC_MAP_FRAMES)) + [(black, black)] * RELOC_BLACK, device)
    ra, rb = (torch.from_numpy(x).to(device) for x in seq.frame(RELOC_REVISIT))
    slam = System(cfg, device=device)
    secs = []
    for i in range(RELOC_MAP_FRAMES):
        timed_track(slam, a[i], b[i], i, secs)
    ok_before = slam.get_tracking_state() == TrackState.OK and slam.num_keyframes() > 5
    for i in range(RELOC_MAP_FRAMES, RELOC_MAP_FRAMES + RELOC_BLACK):
        timed_track(slam, a[i], b[i], i, secs)
    lost = slam.get_tracking_state() == TrackState.LOST
    tries, per_try = None, []
    for j in range(RELOC_TRIES):
        before = dict(kernels.launch_counts)
        timed_track(slam, ra, rb, RELOC_MAP_FRAMES + RELOC_BLACK + j, secs)
        per_try.append({k: kernels.launch_counts[k] - before[k] for k in before})
        if slam.get_tracking_state() == TrackState.OK:
            tries = j
            break
    return slam, seq, secs, ok_before, lost, tries, per_try


def reloc_error(slam, seq) -> float:
    T = slam.results[-1].Tcw
    return float(np.linalg.norm((T @ np.linalg.inv(seq.poses[RELOC_REVISIT]))[:3, 3]))


def check_reloc_path(device) -> dict:
    from orbslam2_tpu_torch import kernels

    kernels.launch_counts.update(hamming=0, pose_gn=0)
    slam, seq, secs, ok_before, lost, tries, per_try = run_reloc_session(bench_config(), device)
    launches = dict(kernels.launch_counts)
    err = reloc_error(slam, seq) if tries is not None else float("inf")
    n = len(secs)
    print(f"relocalization path: {slam.num_keyframes()} keyframes before the blackout "
          f"(OK {ok_before}), LOST after it {lost}; relocalized at revisit {tries} (the reference "
          f"on the CPU: {RELOC640_REFERENCE['relocalized_at_try']}), translation error "
          f"{err:.6f} m (the reference: {RELOC640_REFERENCE['t_err']:.6f}), "
          f"{slam.results[-1].num_inliers} inliers", flush=True)
    print(f"relocalization path: revisit frames {per_try} launches, ms "
          f"{np.round(1000 * np.asarray(secs[RELOC_MAP_FRAMES + RELOC_BLACK:]), 2).tolist()}; "
          f"launches {launches} over {n} frames", flush=True)
    if not (ok_before and lost):
        fail(f"relocalization path: tracked before the blackout {ok_before}, lost after it {lost}")
    if tries is None or not err < RELOC_ERR_M:
        fail(f"relocalization path: relocalized at {tries}, error {err}")
    if min(per_try[tries].values()) < 1:
        fail(f"relocalization path: the relocalizing frame launched {per_try[tries]}")
    return {"launches": launches, "frames": n, "reloc_frame_launches": per_try[tries],
            "reloc_frame_ms": 1000 * secs[-1], "t_err_m": err}


def run_orbit_session(cfg, device) -> dict:
    """The orbit (ORBIT_FRAMES frames) and its revisit (the first
    ORBIT_REVISIT poses again) through `track_rgbd`, loop closing on, with
    the frames staged on `device` first. Returns the session's record:
    `slam`, `seq`, per-frame seconds `secs`, the launches; every keyframe
    decision with its inputs (frame, inliers, the reference keyframe's
    tracked points, close tracked, close free, frames since the last
    keyframe, keyframes, made); every Sim3
    verification (frame, the current and the candidate keyframe's frames,
    n_brute, n_opt, n_guided, ok, its K1 launches) and the frames of the
    global-BA slices; the seconds of the loop closer's warm-up. The
    records read only what the session computes; the frame ids are read
    after the last frame."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.pipeline import fused, loop_closing
    from orbslam2_tpu_torch.pipeline.system import System
    from orbslam2_tpu_torch.solvers import ba

    n = ORBIT_FRAMES + ORBIT_REVISIT
    spec = (ORBIT_FRAMES, "orbit", cfg.camera, ORBIT_REVISIT)
    seq = drive.sequence(spec)
    a, b = staged(render(spec, range(n)), device)
    secs, decisions, verifications, slice_frames, warmup_s = [], [], [], [], []
    slice_fn, verify_fn = ba.bundle_adjust_slice, loop_closing._verify_candidate
    warmup_fn = loop_closing.LoopCloser.warmup_correction
    step_fn = fused.frame_and_keyframe_step
    in_warmup, session = [], []

    def recorded_step(*args, **kw):
        t = session[0].tracker
        since, n_kfs = t.frames_since_kf, t.n_keyframes
        frame, res = step_fn(*args, **kw)
        tr = res.track
        decisions.append((len(secs), res.n_inliers, since, n_kfs, res.is_kf,
                          torch.stack([tr.ref_tracked, tr.close_tracked, tr.close_free])))
        return frame, res

    def counted_slice(*args, **kw):
        if not in_warmup:
            slice_frames.append(len(secs))
        return slice_fn(*args, **kw)

    def recorded_verify(state, kf_id, cand, *args, **kw):
        before = kernels.launch_counts["hamming"]
        out = verify_fn(state, kf_id, cand, *args, **kw)
        if not in_warmup:
            frames = torch.stack([state.kf_frame_id[kf_id], state.kf_frame_id[cand]])
            verifications.append((len(secs), frames, out[0],
                                  kernels.launch_counts["hamming"] - before))
        return out

    def timed_warmup(self, state):
        in_warmup.append(True)
        t0 = time.perf_counter()
        try:
            return warmup_fn(self, state)
        finally:
            warmup_s.append(time.perf_counter() - t0)
            in_warmup.clear()

    ba.bundle_adjust_slice = counted_slice
    loop_closing._verify_candidate = recorded_verify
    loop_closing.LoopCloser.warmup_correction = timed_warmup
    fused.frame_and_keyframe_step = recorded_step
    try:
        kernels.launch_counts.update(hamming=0, pose_gn=0)
        slam = System(cfg, device=device)
        session.append(slam)
        for i in range(n):
            timed_track(slam, a[i], b[i], i, secs)
        t0 = time.perf_counter()
        slam.flush()
        secs[-1] += time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
    finally:
        ba.bundle_adjust_slice = slice_fn
        loop_closing._verify_candidate = verify_fn
        loop_closing.LoopCloser.warmup_correction = warmup_fn
        fused.frame_and_keyframe_step = step_fn
    decisions = [(f, n_inl, *counts.tolist(), since, n_kfs, made)
                 for f, n_inl, since, n_kfs, made, counts in decisions]
    verifications = [dict(frame=f, kf_frame=ids[0], cand_frame=ids[1], n_brute=st[0],
                          n_opt=st[1], n_guided=st[2], ok=bool(st[3]), k1=k1)
                     for f, ids, st, k1 in ((f, ids.tolist(), st.tolist(), k1)
                                            for f, ids, st, k1 in verifications)]
    return dict(slam=slam, seq=seq, secs=secs, launches=launches, decisions=decisions,
                verifications=verifications, slice_frames=slice_frames, warmup_s=warmup_s)


def orbit_outcome(rec: dict) -> dict:
    """The end-to-end figures of an orbit session's record: loops closed
    and the frame of each correction, frames lost and which, ATE over the
    tracked frames, over all frames and over the orbit's frames alone,
    keyframes and their frames, points, the global-BA fold-in frames."""
    from orbslam2_tpu_torch import evaluation

    slam, seq = rec["slam"], rec["seq"]
    _, poses, tracked = slam.frame_poses()
    n = ORBIT_FRAMES + ORBIT_REVISIT
    if poses.shape != (n, 4, 4) or not np.isfinite(poses).all():
        fail(f"orbit: poses of shape {poses.shape}, finite {np.isfinite(poses).all()}")
    lc = slam.loop_closer
    return dict(
        loops_closed=lc.loops_closed if lc is not None else 0,
        loop_frames=drive.frame_events(slam, "loop_closed"),
        lost=int((~tracked).sum()), lost_frames=np.nonzero(~tracked)[0].tolist(),
        ate=float(evaluation.ate_rmse(poses[tracked], seq.poses[tracked], align=True)),
        ate_all=float(evaluation.ate_rmse(poses, seq.poses, align=True)),
        ate_orbit=float(evaluation.ate_rmse(poses[:ORBIT_FRAMES], seq.poses[:ORBIT_FRAMES],
                                            align=True)),
        keyframes=slam.num_keyframes(), points=slam.num_points(),
        keyframe_frames=drive.keyframe_frames(slam),
        fold_frames=drive.frame_events(slam, "gba_folded"))


def check_orbit_path(device, cfg, label: str, ref: dict, must_close: bool) -> dict:
    """The orbit session on the card, against the reference's CPU run:
    the reference's first keyframes (`ref["kf_prefix"]`, the decisions the
    card, the CPU port and the reference share), no more frames lost and
    no more loops closed than the reference, at least one Sim3
    verification in the revisit against a candidate keyframe made in the
    orbit's first ORBIT_REVISIT frames (the true loop), K1 in every
    verification; with `must_close`, at least one loop and the orbit's
    frames (before the revisit) within ORBIT_ATE_LIMIT_M. (Over 205 frames
    float rounding moves later keyframe decisions, and the revisit's last
    frames are where tracking fails in the reference too: the card, the
    CPU port and the reference need not close the same loops; PERF.md.)"""
    rec = run_orbit_session(cfg, device)
    out = orbit_outcome(rec)
    slam, secs, launches, ver = rec["slam"], rec["secs"], rec["launches"], rec["verifications"]
    n = len(secs)
    loops, lost, loop_frames = out["loops_closed"], out["lost"], out["loop_frames"]
    kf_frames = out["keyframe_frames"]

    def frame_ms(f):
        # an event of frame n came in the final flush, timed with the last frame
        return 1000 * secs[min(f, n - 1)]

    print(f"{label}: {loops} loop(s) closed at frames {loop_frames}, {lost} frame(s) lost "
          f"{out['lost_frames']}, ATE {out['ate']:.5f} m over the tracked frames "
          f"({out['ate_all']:.5f} over all, {out['ate_orbit']:.5f} over the orbit's "
          f"{ORBIT_FRAMES}), {out['keyframes']} keyframes, {out['points']} points; the "
          f"reference on the CPU: {ref['loops_closed']} at {ref['loop_frames']}, {ref['lost']} "
          f"lost, ATE {ref['ate']:.5f}", flush=True)
    print(f"{label}: keyframes made at frames {kf_frames}", flush=True)
    print(f"{label}: {len(ver)} Sim3 verifications (frame, current / candidate keyframe's "
          f"frame, n_brute, n_opt, n_guided, ok, K1): "
          f"{[tuple(v.values()) for v in ver]}", flush=True)
    print(f"{label}: loop-closer warm-up {[round(x, 3) for x in rec['warmup_s']]} s; correction "
          f"frame(s) ms {[round(frame_ms(f), 2) for f in loop_frames]}; first verification "
          f"frame ms {[round(frame_ms(v['frame']), 2) for v in ver[:1]]}; global-BA slices "
          f"at frames {rec['slice_frames']}, folded in at frame(s) {out['fold_frames']}",
          flush=True)
    fps = print_rates(label, secs, kf_frames)
    print(f"{label}: launches {launches} over {n} frames", flush=True)
    prefix = ref["kf_prefix"]
    if kf_frames[:len(prefix)] != prefix:
        fail(f"{label}: first keyframes at {kf_frames[:len(prefix)]}, the reference's {prefix}")
    if lost > ref["lost"] or loops > ref["loops_closed"]:
        fail(f"{label}: {loops} loops and {lost} lost frames, the reference "
             f"{ref['loops_closed']} and {ref['lost']}")
    if not any(v["frame"] >= ORBIT_FRAMES and v["cand_frame"] < ORBIT_REVISIT for v in ver):
        fail(f"{label}: no verification of the revisit against a keyframe of the orbit's start")
    if must_close and (loops < 1 or not out["ate_orbit"] < ORBIT_ATE_LIMIT_M):
        fail(f"{label}: {loops} loops, ATE over the orbit's frames {out['ate_orbit']}")
    if min(v["k1"] for v in ver) < 1:
        fail(f"{label}: K1 launches per verification {[v['k1'] for v in ver]}")
    if min(launches.values()) < 1:
        fail(f"{label}: launches {launches}")
    return {"launches": launches, "frames": n, "fps": fps, "loops_closed": loops,
            "loop_frames": loop_frames, "lost": lost, "ate_m": out["ate"],
            "ate_orbit_m": out["ate_orbit"], "k1_per_verification": [v["k1"] for v in ver],
            "gba_slice_frames": rec["slice_frames"], "gba_fold_frames": out["fold_frames"],
            "correction_frame_ms": [frame_ms(f) for f in loop_frames],
            "slice_frame_ms": [frame_ms(f) for f in rec["slice_frames"]]}


def check_loop_cpu_agreement(device) -> None:
    """Loop closing on, the card against the CPU: the 320x240 dolly (18
    frames) and the relocalization session at the CPU tests' 640x480
    configuration. The same keyframes, database rows and relocalization
    frame; per-frame poses within LOOP_CPU_DT_M (the relocalization
    session's earlier frames within RELOC_CPU_DT_M), the last frame's
    within LOOP_CPU_DT_M."""
    cpu = torch.device("cpu")

    def db_rows(slam):
        db = slam.loop_closer.db
        return db.present.cpu(), db.vectors.cpu()

    def compare(label, g, c, extra_ok=True, bar=LOOP_CPU_DT_M):
        kg, kc = drive.keyframe_frames(g), drive.keyframe_frames(c)
        (pg_, vg), (pc_, vc) = db_rows(g), db_rows(c)
        _, pg, tg = g.frame_poses()
        _, pc, tc = c.frame_poses()
        dt, deg = pose_gaps(pg, pc)
        vec_err = float((vg - vc).abs().max())
        print(f"{label}, card vs CPU: keyframes {kg} / {kc}, database rows "
              f"{torch.nonzero(pg_).flatten().tolist()} / {torch.nonzero(pc_).flatten().tolist()} "
              f"(vectors max err {vec_err:.2e}), tracked {int(tg.sum())}/{int(tc.sum())}, max dt "
              f"{dt.max():.3e} m (frame {int(np.argmax(dt))}), max rot {deg.max():.3e} deg", flush=True)
        print(f"{label}, card vs CPU: dt per frame {[float(f'{x:.2e}') for x in dt]}", flush=True)
        if not (extra_ok and kg == kc and torch.equal(pg_, pc_) and vec_err < 1e-6
                and np.array_equal(tg, tc) and dt.max() < bar and dt[-1] < LOOP_CPU_DT_M):
            fail(f"the card and the CPU disagree on the {label}")

    g, _, _ = run_session(small_config(), SMALL_MAP_FRAMES, device, mapping=True, loop_closing=True)
    c, _, _ = run_session(small_config(), SMALL_MAP_FRAMES, cpu, mapping=True, loop_closing=True)
    compare("small session with loop closing", g, c, drive.keyframe_frames(g) == SMALL_MAP_KFS)
    g, seq, _, _, _, tg, _ = run_reloc_session(reloc_small_config(), device)
    c, _, _, _, _, tc, _ = run_reloc_session(reloc_small_config(), cpu)
    print(f"small relocalization session, card vs CPU: relocalized at revisit {tg} / {tc}, "
          f"errors {reloc_error(g, seq):.6f} / {reloc_error(c, seq):.6f} m", flush=True)
    compare("small relocalization session", g, c, tg is not None and tg == tc, RELOC_CPU_DT_M)


def run_localization_session(cfg, n_map: int, yaws, device):
    """`n_map` frames of the dolly with mapping and loop closing on, then
    `activate_localization_mode` and the last mapped frame's pose turned by
    each of `yaws` degrees, every frame through `track_rgbd`. The launch
    counts are set to 0 after the mapping frames. Returns (slam, the turned
    sequence, keyframes before localization, per localization frame its
    mbVO flag, state, ms and launches, the launches over those frames)."""
    from orbslam2_tpu_torch import kernels

    slam, _, _ = run_session(cfg, n_map, device, mapping=True, loop_closing=True)
    n_kf = slam.num_keyframes()
    spec = (n_map, "forward", cfg.camera, 0, tuple(yaws))
    turn = drive.sequence(spec)
    a, b = staged(render(spec, range(len(yaws))), device)
    slam.activate_localization_mode()
    kernels.launch_counts.update(hamming=0, pose_gn=0)
    frames, secs = [], []
    for j in range(len(yaws)):
        before = dict(kernels.launch_counts)
        timed_track(slam, a[j], b[j], n_map + j, secs)
        frames.append(dict(vo=bool(slam.tracker.mb_vo), state=slam.results[-1].state.name,
                           ms=1000 * secs[-1],
                           launches={k: kernels.launch_counts[k] - before[k] for k in before}))
    return slam, turn, n_kf, frames, dict(kernels.launch_counts)


def check_localization_path(device) -> dict:
    """Localization mode at bench.py's configuration after the mapping
    path's 72 frames: the mbVO turn of `tests/test_system_features.py`."""
    cfg = bench_config()
    slam, turn, n_kf, frames, launches = run_localization_session(cfg, MAP_FRAMES, LOC_YAWS,
                                                                  device)
    vo = [f["vo"] for f in frames]
    vo_frames = [j for j, v in enumerate(vo) if v]
    reloc = [j for j in range(1, len(vo)) if vo[j - 1] and not vo[j]]
    err = float(np.linalg.norm((slam.results[-1].Tcw @ np.linalg.inv(turn.poses[-1]))[:3, 3]))
    n_kf_after = slam.num_keyframes()
    # the odometry's own steps (mbVO frames that followed an mbVO or a lost
    # frame; the resolve enters mbVO from coarse tracking) and how far each
    # frame's rotation is from orthonormal (ROADMAP queue 3)
    steps = [j for j in vo_frames if j > 0 and (vo[j - 1] or frames[j - 1]["state"] == "LOST")]
    vo_ok = [j for j in steps if frames[j]["state"] == "OK"]
    R = np.stack([r.Tcw for r in slam.results[-len(frames):]])[:, :3, :3].astype(np.float64)
    off_so3 = np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max(axis=(1, 2))
    entry = vo_frames[0] if vo_frames else 0
    vo_ms = [frames[j]["ms"] for j in vo_frames]
    reloc_ms = [frames[j]["ms"] for j in reloc]
    print(f"localization path: {n_kf} keyframes mapped, {n_kf_after} after {len(frames)} "
          f"localization frames; mbVO on frames {vo_frames}; relocalized out of it at "
          f"{reloc}; states {[f['state'][0] for f in frames]}; last frame {err:.5f} m from "
          f"its ground truth, mbVO {vo[-1]}", flush=True)
    print(f"localization path: {len(vo_ok)} of {len(steps)} odometry steps tracked (frames "
          f"{vo_ok}); max |R^T R - I| {max(off_so3[:entry], default=0):.1e} "
          f"before mbVO, {off_so3[entry]:.1e} at its entry; per frame "
          f"{[float(f'{x:.1e}') for x in off_so3]}", flush=True)
    print(f"localization path: mbVO frames ms median "
          f"{np.median(vo_ms) if vo_ms else float('nan'):.2f} (min "
          f"{min(vo_ms, default=float('nan')):.2f}, max {max(vo_ms, default=float('nan')):.2f}); "
          f"relocalizing frames ms {[round(x, 2) for x in reloc_ms]}; other frames ms median "
          f"{np.median([f['ms'] for f in frames if not f['vo']]):.2f}", flush=True)
    print(f"localization path: launches per mbVO frame "
          f"{[frames[j]['launches']['hamming'] for j in vo_frames]} (K1), per relocalizing "
          f"frame {[frames[j]['launches'] for j in reloc]}; launches {launches} over "
          f"{len(frames)} frames", flush=True)
    if not vo_frames:
        fail("localization path: mbVO never engaged")
    if n_kf_after != n_kf:
        fail(f"localization path: {n_kf} keyframes became {n_kf_after}")
    if vo[-1] or not err < LOC_ERR_M:
        fail(f"localization path: mbVO {vo[-1]} at the end, error {err} m")
    if min(frames[j]["launches"]["hamming"] for j in vo_frames) < 1:
        fail("localization path: an mbVO frame launched no K1")
    if not reloc or frames[reloc[-1]]["launches"]["pose_gn"] < 1:
        fail(f"localization path: relocalizing frames {reloc} launched no K2")
    return {"launches": launches, "frames": len(frames), "vo_frames": len(vo_frames),
            "vo_frame_ms": float(np.median(vo_ms)), "reloc_frame_ms": reloc_ms,
            "k1_per_vo_frame": [frames[j]["launches"]["hamming"] for j in vo_frames],
            "k2_in_relocalizing_frame": frames[reloc[-1]]["launches"]["pose_gn"], "t_err_m": err,
            "odometry_steps_tracked": len(vo_ok)}


def frame_to(frame, device):
    """A FrameData with its tensors on `device`."""
    return type(frame)(*(x.to(device) if isinstance(x, torch.Tensor) else x for x in frame))


def check_localization_cpu_agreement(device) -> None:
    """The small localization session at 320x240 on the card and on the
    CPU: the same mbVO flags and states per frame, and the frames tracked
    against the map (before the odometry and after relocalization) within
    5 mm and 0.2 degrees. Every odometry step of the card is held to the
    CPU's step from the card's own state (last frame, last pose,
    velocity): the pose the step keeps (the optimised pose when it
    tracks, else the motion model's prediction; the optimisation of a
    lost step rests on a handful of inliers and is discarded) within
    VO_STEP_DT_M and VO_STEP_DEG, the inlier counts within
    VO_STEP_INLIERS."""
    from orbslam2_tpu_torch.pipeline import tracking

    cpu = torch.device("cpu")
    plain, steps = tracking.Tracker.visual_odometry, []

    def recorded(self, frame, last_frame, last_Tcw, velocity):
        out = plain(self, frame, last_frame, last_Tcw, velocity)
        steps.append((frame, last_frame, last_Tcw, velocity, out))
        return out

    def kept(out, min_track):
        """The pose a step keeps, its inliers and its optimised pose."""
        Tcw_pred, r = out
        n_inl = int(r.num_inliers)
        T = r.Tcw if n_inl >= min_track else Tcw_pred
        return T.cpu().numpy()[None], n_inl, r.Tcw.cpu().numpy()[None]

    tracking.Tracker.visual_odometry = recorded
    try:
        g, _, kg, fg, _ = run_localization_session(small_config(), SMALL_LOC_MAP_FRAMES,
                                                   SMALL_LOC_YAWS, device)
    finally:
        tracking.Tracker.visual_odometry = plain
    c, _, kc, fc, _ = run_localization_session(small_config(), SMALL_LOC_MAP_FRAMES,
                                               SMALL_LOC_YAWS, cpu)
    n = len(SMALL_LOC_YAWS)
    pg = np.stack([r.Tcw for r in g.results[-n:]])
    pc = np.stack([r.Tcw for r in c.results[-n:]])
    vg, vc = [f["vo"] for f in fg], [f["vo"] for f in fc]
    sg, sc = [f["state"] for f in fg], [f["state"] for f in fc]
    on_map = np.asarray([s_ == "OK" and not v for s_, v in zip(sg, vg)])
    dt, deg = pose_gaps(pg[on_map], pc[on_map])
    min_track = c.cfg.tracking.min_inliers_track
    step_dt, step_deg, step_inl, n_inls, opt_dt = [], [], [], [], []
    for frame, lf, lT, vel, out in steps:
        Tg, ng, opt_g = kept(out, min_track)
        Tc, nc, opt_c = kept(c.tracker.visual_odometry(
            frame_to(frame, cpu), frame_to(lf, cpu), lT.cpu(), None if vel is None else vel.cpu()),
            min_track)
        gap_t, gap_r = pose_gaps(Tg, Tc)
        step_dt.append(float(gap_t[0]))
        step_deg.append(float(gap_r[0]))
        step_inl.append(ng - nc)
        n_inls.append(ng)
        opt_dt.append(float(pose_gaps(opt_g, opt_c)[0][0]))
    tracked = sum(n >= min_track for n in n_inls)
    print(f"small localization session, card vs CPU: mbVO frames "
          f"{[j for j, v in enumerate(vg) if v]} / {[j for j, v in enumerate(vc) if v]}, states "
          f"{''.join(x[0] for x in sg)} / {''.join(x[0] for x in sc)}, keyframes {kg} / {kc}; "
          f"frames on the map max dt {dt.max():.3e} m, max rot {deg.max():.3e} deg", flush=True)
    print(f"small localization session: {len(steps)} odometry steps ({tracked} tracked; inliers "
          f"{n_inls}), each from the card's state, card vs CPU: the kept pose's dt m "
          f"{[float(f'{x:.2e}') for x in step_dt]}, rot deg "
          f"{[float(f'{x:.2e}') for x in step_deg]}, inliers card - CPU {step_inl}; the optimised "
          f"pose's dt m {[float(f'{x:.2e}') for x in opt_dt]}; the whole chain's poses apart by up "
          f"to {np.nanmax(pose_gaps(pg, pc)[0]):.3e} m", flush=True)
    if not (vg == vc and sg == sc and kg == kc and dt.max() < SMALL_DT_M
            and deg.max() < SMALL_DEG):
        fail("the card and the CPU disagree on the small localization session")
    if tracked < VO_MIN_STEPS or not (np.max(step_dt) < VO_STEP_DT_M
                                      and np.max(step_deg) < VO_STEP_DEG
                                      and max(map(abs, step_inl)) <= VO_STEP_INLIERS):
        fail(f"small localization session: {tracked} odometry steps tracked, or a step of the "
             f"card away from the CPU's")


def write_tum_directory(root, seq, frames, cam) -> None:
    """`frames` ((image, depth) each) in TUM RGB-D's layout under `root`,
    with the ground truth of `seq` and an ORB-SLAM2 YAML of `cam`."""
    from PIL import Image

    from orbslam2_tpu_torch import trajectory

    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    stamps = 1000.0 + np.arange(len(frames)) / 30.0
    for t, (img, depth) in zip(stamps, frames):
        g = np.clip(img, 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([g] * 3, axis=-1)).save(os.path.join(root, "rgb", f"{t:.6f}.png"))
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(os.path.join(root, "depth", f"{t:.6f}.png"))
    for name, sub in (("rgb.txt", "rgb"), ("depth.txt", "depth")):
        with open(os.path.join(root, name), "w") as f:
            f.write(f"# {sub}\n" + "".join(f"{t:.6f} {sub}/{t:.6f}.png\n" for t in stamps))
    trajectory.save_tum(os.path.join(root, "groundtruth.txt"), stamps, seq.poses[:len(frames)])
    with open(os.path.join(root, "settings.yaml"), "w") as f:
        f.write("%YAML:1.0\n"
                f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\nCamera.cx: {cam.cx}\n"
                f"Camera.cy: {cam.cy}\nCamera.bf: {cam.bf}\nCamera.fps: {cam.fps}\n"
                f"Camera.width: {cam.width}\nCamera.height: {cam.height}\n"
                "ORBextractor.nFeatures: 1000\nThDepth: 40.0\nDepthMapFactor: 5000.0\n")


def check_cli_path(device) -> dict:
    """`python -m orbslam2_tpu_torch.run --dataset tum` on a directory of
    CLI_FRAMES dolly frames at bench.py's camera, in a child process on
    the card."""
    import tempfile

    from orbslam2_tpu_torch import evaluation, native, trajectory

    if not native.native_available():
        print(f"CLI path: the native decoder did not build: {native.build_error()}", flush=True)
        fail("CLI path: the native decoder is not available")
    cam = bench_config().camera
    spec = (CLI_FRAMES, "forward", cam, 0)
    seq = drive.sequence(spec)
    here = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(here, "orbslam2_tpu_torch", "_build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        root = os.path.join(tmp, "tum")
        write_tum_directory(root, seq, render(spec, range(CLI_FRAMES)), cam)
        out, viz = os.path.join(tmp, "traj.txt"), os.path.join(tmp, "viz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "orbslam2_tpu_torch.run", "--dataset", "tum", "--root", root,
             "--settings", os.path.join(root, "settings.yaml"), "--out", out, "--viz", viz,
             "--device", device.type], cwd=here, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            fail(f"CLI path: the runner exited {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        ts, poses = trajectory.load_tum(out)
        pngs = sorted(os.listdir(viz))
    idx = np.round((np.asarray(ts) - 1000.0) * 30.0).astype(int)
    ate = float(evaluation.ate_rmse(poses, seq.poses[idx], align=True))
    print(f"CLI path: {res}", flush=True)
    print(f"CLI path: {len(ts)}/{CLI_FRAMES} frames in the trajectory, ATE {ate:.5f} m, "
          f"snapshots {pngs}, {wall:.1f} s for the child process", flush=True)
    if res["decoder"] != "native":
        print(f"CLI path: decoder error {res['decoder_error']}", flush=True)
        fail(f"CLI path: decoder {res['decoder']}")
    if res["device"] != torch.cuda.get_device_name(device):
        fail(f"CLI path: ran on {res['device']}")
    if not (res["frames"] == len(ts) == CLI_FRAMES and res["state"] == "OK"):
        fail(f"CLI path: {res['frames']} frames, {len(ts)} tracked, state {res['state']}")
    if not ate < CLI_ATE_LIMIT_M:
        fail(f"CLI path: ATE {ate} >= {CLI_ATE_LIMIT_M}")
    if not ("frame_00000.png" in pngs and "map_00000.png" in pngs):
        fail(f"CLI path: snapshots {pngs}")
    return {"ate_m": ate, "fps": res["fps"], "frames": res["frames"], "wall_s": wall}


def ring_problem(device, n: int, chord: int, seed: int = 0):
    """A drifted ring of `n` keyframes with its loop edge and one chord
    (keyframe 3 to `chord`), built by the port on the CPU (with `n` even, a
    vertex at pi about z, where each package may pack its rotation as q or
    -q), then moved to `device`."""
    from orbslam2_tpu_torch.geometry import se3
    from orbslam2_tpu_torch.solvers import pose_graph

    g = torch.Generator().manual_seed(seed)
    gt = torch.stack([se3.exp_se3(torch.tensor([np.cos(2 * np.pi * i / n), np.sin(2 * np.pi * i / n),
                                                0, 0, 0, 2 * np.pi * i / n], dtype=torch.float32))
                      for i in range(n)])
    est = torch.stack([gt[0]] + [se3.exp_se3(0.003 * i * torch.randn(6, generator=g)) @ gt[i]
                                 for i in range(1, n)])
    ei = list(range(n - 1)) + [n - 1, 3]
    ej = list(range(1, n)) + [0, chord]
    meas = torch.stack([pose_graph.se3_to_pack(gt[b] @ se3.inverse(gt[a])) for a, b in zip(ei, ej)])
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[0] = True
    prob = pose_graph.PoseGraphProblem(
        vertices=pose_graph.se3_to_pack(est), vertex_valid=torch.ones(n, dtype=torch.bool),
        vertex_fixed=fixed, edge_i=torch.tensor(ei, dtype=torch.int32),
        edge_j=torch.tensor(ej, dtype=torch.int32), edge_meas=meas,
        edge_valid=torch.ones(len(ei), dtype=torch.bool),
        edge_weight=torch.tensor([1.0] * (n - 1) + [5.0, 1.0]))
    return pose_graph.PoseGraphProblem(*(x.to(device) for x in prob))


def sign_aligned(a, b) -> torch.Tensor:
    """`a`'s packed sim3s [..., 8] = (s, q, t), float64 on the CPU, each
    quaternion given the sign of its dot product with `b`'s: q and -q are
    one rotation, and `rot_to_quat` picks between them on the sign of a
    rounding residue where qw is near 0 (a rotation near pi)."""
    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    sign = torch.where(torch.sum(a[..., 1:5] * b[..., 1:5], dim=-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.cat([a[..., :1], a[..., 1:5] * sign, a[..., 5:]], dim=-1)


def packs_gap(a, b) -> float:
    """Largest difference of two packed sim3 arrays, up to each
    quaternion's sign."""
    return float((sign_aligned(a, b) - torch.as_tensor(b).double().cpu()).abs().max())


def check_pcg(device) -> None:
    """The essential graph's PCG solve, as the loop closer calls it past
    `pose_graph_dense_max_k`, on the card against the CPU."""
    from orbslam2_tpu_torch.config import SolverConfig
    from orbslam2_tpu_torch.solvers import pose_graph

    sc = SolverConfig()
    if not PCG_KEYFRAMES > sc.pose_graph_dense_max_k:
        fail(f"PCG: {PCG_KEYFRAMES} keyframes would take the dense solve")
    out = {}
    for d in (device, torch.device("cpu")):
        prob = ring_problem(d, PCG_KEYFRAMES, PCG_KEYFRAMES // 2)
        t0 = time.perf_counter()
        out[d.type] = pose_graph.optimize_pose_graph_pcg(prob, iters=sc.pose_graph_iters,
                                                         cg_iters=sc.pose_graph_cg_iters)
        if d.type == "cuda":
            torch.cuda.synchronize()
        out[d.type + "_s"] = time.perf_counter() - t0
    gap = packs_gap(out["cuda"], out["cpu"])
    start = ring_problem("cpu", PCG_KEYFRAMES, PCG_KEYFRAMES // 2).vertices
    moved = packs_gap(out["cpu"], start)
    print(f"PCG essential graph, {PCG_KEYFRAMES} keyframes ({sc.pose_graph_iters} iterations, "
          f"{sc.pose_graph_cg_iters} CG): card vs CPU max gap {gap:.3e} (the solve moved the "
          f"packs by up to {moved:.3e}); {out['cuda_s']:.2f} s on the card, {out['cpu_s']:.2f} s "
          f"on the CPU", flush=True)
    if not (torch.isfinite(out["cuda"]).all() and gap <= TOL_PCG and moved > 10 * TOL_PCG):
        fail(f"PCG: card vs CPU gap {gap}, moved {moved}")


def matching_frame():
    """`graft_entry.entry`'s arguments for a frame it can track: frame 1 of
    the forward dolly rendered at the entry's camera (`CameraConfig()`),
    and a map point for each feature the port's extraction finds on it
    with a depth (the feature's pixel lifted with the rendered depth and
    the true pose, with the feature's descriptor), the rest of the
    `LOCAL_POINTS` slots empty. Tcw0 is the true pose moved by ~1 cm and
    ~0.2 degrees. Numpy arrays, made on the CPU."""
    from orbslam2_tpu_torch.config import CameraConfig, OrbConfig
    from orbslam2_tpu_torch.geometry import se3
    from orbslam2_tpu_torch.graft_entry import LOCAL_POINTS
    from orbslam2_tpu_torch.ops.orb import OrbExtractor

    cam = CameraConfig()
    seq = drive.sequence((2, "forward", cam, 0))
    image, depth = seq.frame(1)
    feats = OrbExtractor(OrbConfig(num_features=1000, feature_slots=1024))(
        torch.from_numpy(image))
    xy = feats.xy.numpy().astype(np.float64)
    px = np.clip(np.round(xy).astype(np.int64), 0, [cam.width - 1, cam.height - 1])
    z = depth[px[:, 1], px[:, 0]].astype(np.float64)
    keep = feats.valid.numpy() & np.isfinite(z) & (z > 0.1)
    pc = np.stack([(xy[:, 0] - cam.cx) / cam.fx * z, (xy[:, 1] - cam.cy) / cam.fy * z, z], -1)
    Twc = np.linalg.inv(seq.poses[1])
    pw = pc[keep] @ Twc[:3, :3].T + Twc[:3, 3]
    m = len(pw)
    mp_pos = np.zeros((LOCAL_POINTS, 3), np.float32)
    mp_desc = np.zeros((LOCAL_POINTS, 8), np.int32)
    mp_pos[:m], mp_desc[:m] = pw, feats.desc.numpy()[keep]
    nudge = se3.exp_se3(torch.tensor([0.008, -0.004, 0.006, 0.002, -0.003, 0.001])).numpy()
    Tcw0 = (nudge.astype(np.float64) @ seq.poses[1]).astype(np.float32)
    return image, mp_pos, mp_desc, np.arange(LOCAL_POINTS) < m, Tcw0


def check_graft_entry(device) -> dict:
    """`graft_entry.entry()`'s function on the card against the port on the
    CPU, on its own example arguments and on `matching_frame()`: at least
    99 % of the descriptors equal (`test_torch_orb.py`'s bar: a cos/sin
    rounding at a .5 boundary flips one BRIEF sample), Tcw within 1e-4,
    the same inliers. The card's two calls are the graft-entry path: K1
    and K2 each launched in both."""
    from orbslam2_tpu_torch import graft_entry, kernels

    fn_card, example = graft_entry.entry(device)
    fn_cpu, _ = graft_entry.entry("cpu")
    frames = {"example": tuple(a.cpu().numpy() for a in example), "matching": matching_frame()}
    kernels.launch_counts.update(hamming=0, pose_gn=0)
    outs = {k: fn_card(*(torch.from_numpy(a).to(device) for a in v)) for k, v in frames.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    for k, v in frames.items():
        card = outs[k]
        cpu = fn_cpu(*(torch.from_numpy(a) for a in v))
        same = (card[2].cpu() == cpu[2]).all(dim=1).double().mean().item()
        gap = float((card[0].cpu() - cpu[0]).abs().max())
        n_card, n_cpu = int(card[1]), int(cpu[1])
        print(f"graft entry, {k} frame: card {n_card} inliers, CPU {n_cpu}; pose gap {gap:.3e}; "
              f"descriptors equal {same:.4f}", flush=True)
        if not (n_card == n_cpu and gap <= GRAFT_TCW_TOL and same >= GRAFT_DESC_SHARE
                and torch.isfinite(card[0]).all()):
            fail(f"graft entry ({k} frame): card against CPU")
    if int(outs["matching"][1]) <= GRAFT_MIN_INLIERS:
        fail(f"graft entry: {int(outs['matching'][1])} inliers on the matching frame")
    print(f"graft entry: launches {launches} over {len(frames)} calls", flush=True)
    for name, n in launches.items():
        if n < len(frames):
            fail(f"graft entry launched {name} {n} times in {len(frames)} calls")
    return {"launches": launches, "frames": len(frames)}


def scaling_ba_problem(seed: int = 0) -> dict:
    """`bench_scaling.py`'s global-BA problem as numpy arrays: C = 64
    cameras 0.4 m apart along x, turning 0.01 rad each; P = 32768 points
    seen by O = 8 random cameras each, 0.3 px of pixel noise, points
    perturbed by 5 cm, the first 2 cameras fixed."""
    C, Pn, O = SHARD_BA_SHAPE
    rng = np.random.default_rng(seed)
    cams = np.zeros((C, 4, 4))
    for i in range(C):
        a = 0.01 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        # exp of the twist (0.4 i, 0, 0 | 0, a, 0): t = V rho
        V = np.eye(3) if a == 0 else (np.eye(3) + (1 - np.cos(a)) / a**2 * np.array(
            [[0, 0, a], [0, 0, 0], [-a, 0, 0]]) + (a - np.sin(a)) / a**3 * np.array(
            [[-a * a, 0, 0], [0, 0, 0], [0, 0, -a * a]]))
        cams[i, :3, :3], cams[i, :3, 3], cams[i, 3, 3] = R, V @ [0.4 * i, 0, 0], 1.0
    cams = cams.astype(np.float32)
    pts = np.c_[rng.uniform(-5, 30, Pn), rng.uniform(-4, 4, Pn),
                rng.uniform(4, 30, Pn)].astype(np.float32)
    obs_cam = np.stack([rng.permutation(C)[:O] for _ in range(Pn)]).astype(np.int32)
    Ts = cams[obs_cam]
    pc = np.einsum("poij,pj->poi", Ts[..., :3, :3], pts) + Ts[..., :3, 3]
    z = np.maximum(pc[..., 2], 0.1)
    uv = np.stack([480.0 * pc[..., 0] / z + 319.5, 480.0 * pc[..., 1] / z + 239.5],
                  axis=-1).astype(np.float32)
    return dict(
        cam_Tcw=cams, cam_free=np.arange(C) >= 2,
        points=pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
        point_valid=np.ones(Pn, bool), obs_cam=obs_cam,
        obs_uv=uv + rng.normal(0, 0.3, uv.shape).astype(np.float32),
        obs_ur=np.full((Pn, O), -1.0, np.float32), obs_inv_sigma2=np.ones((Pn, O), np.float32),
        obs_valid=pc[..., 2] > 0.5)


def scaling_pose_graph(device, seed: int = 1):
    """`bench_scaling.py`'s pose graph: K = 256 keyframes 0.3 m apart,
    turning 0.02 rad each, E = 8192 random edges from each keyframe to one
    of the next 8, measured from the true poses, keyframe 0 fixed; the
    vertices start off the truth by a random twist of 0.01 per axis, so the
    solve has work to do."""
    from orbslam2_tpu_torch.geometry import se3
    from orbslam2_tpu_torch.solvers import pose_graph

    Kv, E = SHARD_PG_SHAPE
    rng = np.random.default_rng(seed)
    Ts = torch.stack([se3.exp_se3(torch.tensor([0.3 * i, 0, 0, 0, 0.02 * i, 0]))
                      for i in range(Kv)])
    ei = rng.integers(0, Kv, E)
    ej = (ei + 1 + rng.integers(0, 8, E)) % Kv
    meas = pose_graph.se3_to_pack(Ts[ej] @ torch.linalg.inv(Ts[ei]))
    drift = torch.from_numpy(rng.normal(0, 0.01, (Kv, 6)).astype(np.float32))
    drift[0] = 0
    prob = pose_graph.PoseGraphProblem(
        vertices=pose_graph.se3_to_pack(se3.exp_se3(drift) @ Ts), vertex_valid=torch.ones(Kv, dtype=torch.bool),
        vertex_fixed=torch.arange(Kv) == 0, edge_i=torch.from_numpy(ei.astype(np.int32)),
        edge_j=torch.from_numpy(ej.astype(np.int32)), edge_meas=meas,
        edge_valid=torch.ones(E, dtype=torch.bool), edge_weight=torch.ones(E))
    return pose_graph.PoseGraphProblem(*(x.to(device) for x in prob))


def scaling_bow_query(device, seed: int = 2) -> tuple:
    """`bench_scaling.py`'s database: K = 4096 BoW rows over V = 4096 words,
    1 % of the covisibility weights set, the query keyframe K/2's row."""
    Kb, V = SHARD_BOW_SHAPE
    rng = np.random.default_rng(seed)
    vecs = rng.uniform(0, 1, (Kb, V)).astype(np.float32)
    vecs /= vecs.sum(axis=1, keepdims=True)
    covis = (rng.uniform(0, 1, (Kb, Kb)) > 0.99).astype(np.float32) * 40
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(vecs), torch.ones(Kb, dtype=torch.bool, device=device), t(vecs[Kb // 2]),
            torch.zeros(Kb, dtype=torch.bool, device=device), 0.01, t(covis))


def check_sharded(device, card: str) -> None:
    """The multi-device slice at world size 1: this process as the one rank
    of an NCCL group, each sharded function against the port's
    single-device solver on the same card, then the group destroyed."""
    import tempfile

    from orbslam2_tpu_torch import convert
    from orbslam2_tpu_torch.config import CameraConfig
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.parallel import group, sharded_ba, sharded_bow, sharded_pose_graph
    from orbslam2_tpu_torch.solvers import ba, pose_graph
    from orbslam2_tpu_torch.vocab import database

    C, Pn, O = SHARD_BA_SHAPE
    K = Intrinsics.from_config(CameraConfig(fx=480.0, fy=480.0, bf=240.0), device)
    prob = convert.ba_problem_from_numpy(scaling_ba_problem(), device)
    it = SHARD_BA_ITERS
    store = os.path.join(tempfile.mkdtemp(prefix="smoke-group-"), "store")
    with group.member(0, 1, store, device):
        direct = lambda: sharded_ba.sharded_bundle_adjust(prob, K, iters=it)  # noqa: E731
        pcg = lambda: sharded_ba.sharded_bundle_adjust(  # noqa: E731
            prob, K, iters=it, camera_solver="pcg")
        cam_d, pts_d, cost_d = direct()
        cam_p, _, cost_p = pcg()
        single = ba.bundle_adjust(prob, K, iters=it)
        ms_direct, ms_pcg = call_ms(direct, reps=2), call_ms(pcg, reps=2)
        ms_single = call_ms(lambda: ba.bundle_adjust(prob, K, iters=it), reps=2)
        same = (torch.equal(cam_d, single.cam_Tcw) and torch.equal(pts_d, single.points)
                and torch.equal(cost_d, single.cost))
        print(f"sharded BA (direct, world 1, C={C} P={Pn} O={O}, {it} iterations): cost "
              f"{float(cost_d):.6f}, bundle_adjust {float(single.cost):.6f}, bit-equal {same}",
              flush=True)
        if not same:
            fail("sharded BA (direct) at world size 1 differs from bundle_adjust")
        print(f"sharded BA (pcg, {SHARD_CG} CG steps, world 1, {it} iterations): cost "
              f"{float(cost_p):.6f} beside direct's {float(cost_d):.6f} (relative "
              f"{float((cost_p - cost_d) / cost_d):.3e}), cameras within "
              f"{float((cam_p - cam_d).abs().max()):.3e}", flush=True)
        if not cost_p < ba.bundle_adjust(prob, K, iters=0).cost:
            fail("sharded BA (pcg) did not lower the cost")
        # the first step's camera solve against a float64 dense solve of
        # the same system
        lam = torch.tensor(1e-4, device=device)
        terms = ba._edge_terms(prob.cam_Tcw, prob.points, prob, K, True)
        S, g_S, _ = ba.reduced_system(*terms[:4], prob, lam, ba._assembly(prob))
        exact = ba.solve_cameras(S.double(), g_S.double(), prob.cam_free, lam.double())
        dx_pcg = sharded_ba.solve_cameras_pcg(S, g_S, prob.cam_free, lam, SHARD_CG)
        dx_dir = ba.solve_cameras(S, g_S, prob.cam_free, lam)
        rel = float((dx_pcg.double() - exact).norm() / exact.norm())
        rel_dir = float((dx_dir.double() - exact).norm() / exact.norm())
        print(f"sharded BA first step (against a float64 dense solve of the same system, "
              f"|exact| {float(exact.norm()):.6e}): pcg ({SHARD_CG} CG steps) relative {rel:.3e}; "
              f"float32 direct relative {rel_dir:.3e}", flush=True)
        if not rel <= TOL_PCG_STEP:
            fail(f"sharded BA pcg first step {rel} from the float64 solve")

        gprob = scaling_pose_graph(device)
        gi = SHARD_PG_ITERS
        single_pg = pose_graph.optimize_pose_graph_pcg(gprob, iters=gi)
        ms_pg = call_ms(lambda: pose_graph.optimize_pose_graph_pcg(gprob, iters=gi), reps=2)
        ms_modes = {}
        for inner in ("gathered", "stepped"):
            def solve():
                return sharded_pose_graph.sharded_optimize_pose_graph(gprob, iters=gi, inner=inner)

            out = solve()
            ms_modes[inner] = call_ms(solve, reps=2)
            same = torch.equal(out, single_pg)
            print(f"sharded pose graph ({inner}, world 1, K={gprob.vertices.shape[0]} "
                  f"E={gprob.edge_i.shape[0]}, {gi} iterations): gap "
                  f"{float((out - single_pg).abs().max()):.3e} to the single-device PCG, "
                  f"bit-equal {same}; the solve moved the packs by up to "
                  f"{packs_gap(out, gprob.vertices):.3e}", flush=True)
            if not same:
                fail(f"sharded pose graph ({inner}) differs from the single-device PCG")

        args = scaling_bow_query(device)
        got, ref = sharded_bow.sharded_query(*args), database._query(*args)
        ms_q = call_ms(lambda: sharded_bow.sharded_query(*args))
        ms_db = call_ms(lambda: database._query(*args))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"sharded BoW query (world 1, K={args[0].shape[0]} V={args[0].shape[1]}): "
              f"candidates {got[0].tolist()} (mask {got[1].tolist()}), identical to "
              f"database._query {same}", flush=True)
        if not same:
            fail("sharded BoW query differs from database._query")
    print(f"{card}: ms per LM iteration (C={C}, P={Pn}), sharded at world 1 direct "
          f"{ms_direct / it:.2f}, pcg {ms_pcg / it:.2f}, bundle_adjust {ms_single / it:.2f}; "
          f"ms per Gauss-Newton iteration (K={SHARD_PG_SHAPE[0]}, E={SHARD_PG_SHAPE[1]}), "
          f"gathered {ms_modes['gathered'] / gi:.2f}, stepped {ms_modes['stepped'] / gi:.2f}, "
          f"single-device PCG {ms_pg / gi:.2f}; ms per BoW query (K={SHARD_BOW_SHAPE[0]}), "
          f"sharded {ms_q:.3f}, database._query {ms_db:.3f}", flush=True)


def check_dryrun() -> None:
    """`dryrun_multichip(1)` in a spawned rank on the card; a second rank
    is refused on one card."""
    from orbslam2_tpu_torch import graft_entry

    graft_entry.dryrun_multichip(1)
    n = torch.cuda.device_count() + 1
    try:
        graft_entry.dryrun_multichip(n)
    except RuntimeError as e:
        print(f"dryrun_multichip({n}) refused: {e}", flush=True)
    else:
        fail(f"dryrun_multichip({n}) ran on {n - 1} card(s)")


def orbit320_pcg_config():
    """The 320x240 orbit with `pose_graph_dense_max_k` below its keyframe
    slots: every loop correction solves the essential graph by PCG."""
    cfg = orbit320_config()
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, pose_graph_dense_max_k=ORBIT320_PCG_DENSE_MAX_K))


def check_orbit_pcg_path(device) -> dict:
    """Phase 21(a): the 320x240 orbit with the PCG correction on the card:
    the reference's keyframes through its correction, no fewer loops closed
    and no more frames lost than the reference's run of the same session,
    each correction through `pose_graph.optimize_pose_graph_pcg` (counted
    by `longrun.LoopProbe`, which wraps the solvers) and none through the
    dense solve, K1 in every verification."""
    from orbslam2_tpu_torch.longrun import LoopProbe

    cfg, ref, label = orbit320_pcg_config(), ORBIT320_PCG_REFERENCE, "320x240 orbit, PCG"
    if not cfg.map.max_keyframes > cfg.solver.pose_graph_dense_max_k:
        fail(f"{label}: {cfg.map.max_keyframes} keyframe slots would take the dense solve")
    probe = LoopProbe()
    try:
        rec = run_orbit_session(cfg, device)
    finally:
        probe.close()
    out = orbit_outcome(rec)
    secs, ver, solves = rec["secs"], rec["verifications"], probe.counts()
    loops, lost, n = out["loops_closed"], out["lost"], len(secs)
    kf_frames = out["keyframe_frames"]
    print(f"{label}: {loops} loop(s) closed at frames {out['loop_frames']}, {lost} frame(s) lost "
          f"{out['lost_frames']}, ATE {out['ate']:.5f} m over the tracked frames "
          f"({out['ate_orbit']:.5f} over the orbit's {ORBIT_FRAMES}), {out['keyframes']} keyframes;"
          f" the reference on the CPU: {ref['loops_closed']} at {ref['loop_frames']}, "
          f"{ref['lost']} lost, ATE {ref['ate']:.5f}", flush=True)
    print(f"{label}: keyframes made at frames {kf_frames}", flush=True)
    print(f"{label}: essential-graph solves {solves}; correction frame(s) ms "
          f"{[round(1000 * secs[min(f, n - 1)], 2) for f in out['loop_frames']]}; "
          f"{len(ver)} Sim3 verifications", flush=True)
    fps = print_rates(label, secs, kf_frames)
    prefix = ref["kf_prefix"]
    if kf_frames[:len(prefix)] != prefix:
        fail(f"{label}: first keyframes at {kf_frames[:len(prefix)]}, the reference's {prefix}")
    if loops < ref["loops_closed"] or lost > ref["lost"]:
        fail(f"{label}: {loops} loops and {lost} lost frames, the reference "
             f"{ref['loops_closed']} and {ref['lost']}")
    if solves != {"pcg": loops, "dense": 0}:
        fail(f"{label}: essential-graph solves {solves} for {loops} corrections")
    if not ver or min(v["k1"] for v in ver) < 1 or min(rec["launches"].values()) < 1:
        fail(f"{label}: K1 per verification {[v['k1'] for v in ver]}, launches {rec['launches']}")
    return {"launches": rec["launches"], "frames": n, "fps": fps, "loops_closed": loops,
            "lost": lost, "k1_per_verification": [v["k1"] for v in ver], "solves": solves}


def check_recycling_cpu_agreement(device) -> None:
    """Phase 21(c): slot recycling in a live session, the card against
    the CPU: the 320x240 orbit's first RECYCLE_FRAMES frames with loop
    closing on and RECYCLE_SLOTS keyframe slots. The reference's keyframes
    and culled slots in its order, more keyframes inserted than slots, the
    same database rows, per-frame poses within SMALL_DT_M and SMALL_DEG."""
    from orbslam2_tpu_torch.pipeline import local_mapping as lm
    from orbslam2_tpu_torch.pipeline.system import System

    cfg = orbit320_config()
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, max_keyframes=RECYCLE_SLOTS))
    frames = render((ORBIT_FRAMES, "orbit", cfg.camera, 0), range(RECYCLE_FRAMES))
    cull, runs = lm.LocalMapper._cull, {}
    for d in (device, torch.device("cpu")):
        culled = []
        lm.LocalMapper._cull = lambda self, st, c: culled.append(c) or cull(self, st, c)
        try:
            a, b = staged(frames, d)
            slam = System(cfg, device=d)
            for i in range(RECYCLE_FRAMES):
                slam.track_rgbd(a[i], b[i], timestamp=i / 30.0)
        finally:
            lm.LocalMapper._cull = cull
        runs[d.type] = (slam, culled, *slam.frame_poses()[1:])
    (g, cg, pg, tg), (c, cc, pc, tc) = runs["cuda"], runs["cpu"]
    dt, deg = pose_gaps(pg, pc)
    kg, kc = drive.keyframe_frames(g), drive.keyframe_frames(c)
    same_db = (torch.equal(g.loop_closer.db.present.cpu(), c.loop_closer.db.present)
               and float((g.loop_closer.db.vectors.cpu() - c.loop_closer.db.vectors).abs().max())
               < 1e-6)
    print(f"recycling session, card vs CPU: keyframes {kg} / {kc}, culled slots {cg} / {cc}, "
          f"inserted {int(g.map.num_kf)} / {int(c.map.num_kf)} into {RECYCLE_SLOTS} slots, "
          f"database rows equal {same_db}, tracked {int(tg.sum())}/{int(tc.sum())}, max dt "
          f"{dt.max():.3e} m, max rot {deg.max():.3e} deg", flush=True)
    if not (kg == kc == RECYCLE_KFS and cg == cc == RECYCLE_CULLED
            and int(g.map.num_kf) == int(c.map.num_kf) > RECYCLE_SLOTS and same_db
            and tg.all() and tc.all() and dt.max() < SMALL_DT_M and deg.max() < SMALL_DEG):
        fail("the card and the CPU disagree on the recycling session")


def check_scale(device) -> None:
    """Phase 21(b): `orbslam2_tpu_torch.scale`'s stages at SCALE_SHAPE on
    the card, its graph stages again on the CPU: the dropped observations,
    the observation tables, the covisibility, the edge count and edges
    equal, the pose-graph vertices within TOL_PCG up to each quaternion's
    sign; the BA cost after 2 iterations finite and below its start."""
    from orbslam2_tpu_torch import scale
    from orbslam2_tpu_torch.solvers import pose_graph

    K, P = SCALE_SHAPE
    cpu = torch.device("cpu")
    torch.cuda.reset_peak_memory_stats(device)
    states, res = {}, {}
    for d in (device, cpu):
        t0 = time.perf_counter()
        states[d.type] = scale.build_state(K, P, scale.SLOTS, scale.OBS, scale.SEED, d)
        res[d.type] = scale.graph_stages(states[d.type], d)
        res[d.type]["seconds"]["build_s"] = time.perf_counter() - t0 - sum(
            res[d.type]["seconds"].values())
    g, c_ = res["cuda"], res["cpu"]
    gba = scale.ba_stage(states["cuda"], device)
    peak = torch.cuda.max_memory_allocated(device)
    gap = packs_gap(g["packs"], c_["packs"])
    moved = packs_gap(c_["packs"], pose_graph.se3_to_pack(states["cpu"].kf_Tcw))
    same = {f: torch.equal(getattr(states["cuda"], f).cpu(), getattr(states["cpu"], f))
            for f in ("mp_obs_kf", "mp_obs_feat", "mp_n_obs", "covis")}
    same["edges"] = all(torch.equal(a.cpu(), b) for a, b in zip(g["edges"][:2] + g["edges"][3:],
                                                                 c_["edges"][:2] + c_["edges"][3:]))
    print(f"scale, K={K} P={P}: edges {g['edges_total']} / {c_['edges_total']}, observations "
          f"dropped {g['obs_truncated']} / {c_['obs_truncated']} (card / CPU), equal {same}; "
          f"pose graph card vs CPU max gap {gap:.3e} (the solve moved the packs by up to "
          f"{moved:.3e}); global BA cost {gba['gba_cost_start']:.6g} "
          f"-> {gba['gba_cost']:.6g} after 2 iterations; peak device bytes {peak}", flush=True)
    print(f"scale: seconds on the card {g['seconds']} {gba['seconds']}; on the CPU "
          f"{c_['seconds']}", flush=True)
    if not (all(same.values()) and g["edges_total"] == c_["edges_total"]
            and g["obs_truncated"] == c_["obs_truncated"]):
        fail(f"scale: the card's integer results differ from the CPU's ({same})")
    if not (torch.isfinite(g["packs"]).all() and gap <= TOL_PCG):
        fail(f"scale: pose graph card vs CPU gap {gap}")
    if not (np.isfinite(gba["gba_cost"]) and gba["gba_cost"] < gba["gba_cost_start"]):
        fail(f"scale: BA cost {gba['gba_cost_start']} -> {gba['gba_cost']}")


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        sys.exit(2)
    device = torch.device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    card = drive.card_line()
    print(card, flush=True)

    start_render_pool()
    try:
        run_phases(device, card)
    finally:
        stop_render_pool()


def run_phases(device, card: str) -> None:
    from orbslam2_tpu_torch import kernels

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
    t = time_k1_at(device, mapping["union_rows"], mapping["slots"], "union fuse")
    k1["shapes"][t["shape"]] = t
    check_small_cpu_agreement(device, small_config(), SMALL_MAP_FRAMES, "small mapping session",
                              expect_kfs=SMALL_MAP_KFS)
    stereo_path = check_stereo_path(device)
    mono_path = check_mono_path(device)
    t = time_k1_at(device, mono_path["search_rows"], mono_path["slots"], "mono search")
    k1["shapes"][t["shape"]] = t
    check_small_cpu_agreement(device, stereo_config(small_config()), SMALL_MAP_FRAMES,
                              "small stereo session")
    check_small_cpu_agreement(device, mono_config(), SMALL_MONO_FRAMES, "small mono session")
    t0 = time.perf_counter()
    reloc = check_reloc_path(device)
    orbit640 = check_orbit_path(device, orbit640_config(), "640x480 orbit", ORBIT640_REFERENCE,
                                must_close=False)
    orbit320 = check_orbit_path(device, orbit320_config(), "320x240 orbit", ORBIT320_REFERENCE,
                                must_close=True)
    check_loop_cpu_agreement(device)
    print(f"loop-closing phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    localization = check_localization_path(device)
    check_localization_cpu_agreement(device)
    cli = check_cli_path(device)
    check_pcg(device)
    print(f"localization, CLI and PCG phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    graft = check_graft_entry(device)
    check_sharded(device, card)
    check_dryrun()
    print(f"graft entry and sharded phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    orbit_pcg = check_orbit_pcg_path(device)
    check_scale(device)
    check_recycling_cpu_agreement(device)
    print(f"long-session phases: {time.perf_counter() - t0:.1f} s", flush=True)

    if "jax" in sys.modules:
        fail("jax was imported")
    paths = (main_path, mapping, stereo_path, mono_path, reloc, orbit640, orbit320, localization,
             graft, orbit_pcg)
    names = ("rgbd_tracking", "rgbd_mapping", "stereo_mapping", "mono_mapping",
             "rgbd_relocalization", "rgbd_orbit_640", "rgbd_orbit_320", "rgbd_localization",
             "graft_entry", "rgbd_orbit_320_pcg")
    for k, key in ((k1, "hamming"), (k2, "pose_gn")):
        k["launches"] = sum(p["launches"][key] for p in paths)
        k["launches_per_path"] = {name: {"launches": p["launches"][key], "frames": p["frames"]}
                                  for name, p in zip(names, paths)}
    per = k1["launches_per_path"]
    per["rgbd_mapping"]["per_keyframe_step"] = mapping["k1_per_keyframe_step"]
    per["stereo_mapping"]["per_stereo_match"] = stereo_path["k1_per_stereo_match"]
    per["mono_mapping"]["per_init_search"] = mono_path["k1_per_init_search"]
    for name, p in (("rgbd_orbit_640", orbit640), ("rgbd_orbit_320", orbit320),
                    ("rgbd_orbit_320_pcg", orbit_pcg)):
        per[name]["per_verification"] = p["k1_per_verification"]
    for k, key in ((k1, "hamming"), (k2, "pose_gn")):
        k["launches_per_path"]["rgbd_relocalization"]["in_relocalizing_frame"] = \
            reloc["reloc_frame_launches"][key]
    per["rgbd_localization"]["per_vo_frame"] = localization["k1_per_vo_frame"]
    k2["launches_per_path"]["rgbd_localization"]["in_relocalizing_frame"] = \
        localization["k2_in_relocalizing_frame"]
    print(f"CLI path (a child process; its launches are not counted here): "
          f"{cli['frames']} frames, ATE {cli['ate_m']:.5f} m, {cli['fps']} frames/s", flush=True)
    for name, p in zip(names, paths):
        print(f"{name}: launches per frame, K1 {p['launches']['hamming'] / p['frames']:.2f}, "
              f"K2 {p['launches']['pose_gn'] / p['frames']:.2f} ({p['frames']} frames)",
              flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s from the build to the last phase",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
