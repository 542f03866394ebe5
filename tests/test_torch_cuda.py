"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: they skip where no CUDA device is present. On a GPU
machine without JAX, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m", [(1024, 1024), (4096, 1024), (100, 300), (1, 1), (1023, 1025),
                                 (2525, 1024), (1280, 1280), (0, 64), (64, 0)])
def test_hamming_kernel_matches_plain(device, n, m):
    """Exact at the paths' shapes, at ragged and empty ones, on rows of all
    zeros, all ones, the sign bit alone and all but the sign bit (distances
    0 to 256, words negative as int32)."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.ops import cuda_hamming, hamming
    from chip_smoke import edge_descs

    rng = np.random.default_rng(n + m)
    a, b = edge_descs(rng, n, device), edge_descs(rng, m, device)
    before = kernels.launch_counts["hamming"]
    got = cuda_hamming.distance_matrix(a, b)
    assert kernels.launch_counts["hamming"] == before + (1 if n and m else 0)
    assert got.shape == (n, m) and got.dtype == torch.int32
    assert torch.equal(got, hamming.distance_matrix(a, b))


@pytest.mark.parametrize("n,n_real,rounds,iters", [
    (1024, 700, 4, 10), (1024, 700, 2, 6), (1024, 700, 3, 6), (1024, 700, 4, 6), (700, 600, 2, 6),
])
def test_pose_kernel_matches_plain(device, n, n_real, rounds, iters):
    """Tcw to atol 1e-4 (float32 sums in another order) and equal inlier
    sets, NaN in the padded slots."""
    from orbslam2_tpu_torch import config, kernels
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.solvers import cuda_pose_opt, pose_opt
    from chip_smoke import make_pose_problem

    K = Intrinsics.from_config(config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0),
                               device)
    obs = make_pose_problem(np.random.default_rng(0), device, n=n, n_real=n_real)
    before = kernels.launch_counts["pose_gn"]
    got = cuda_pose_opt.pose_optimize_fast(torch.eye(4, device=device), obs, K, rounds, iters)
    assert kernels.launch_counts["pose_gn"] == before + 1
    ref = pose_opt.pose_optimize(torch.eye(4, device=device), obs, K, rounds, iters)
    assert float((got.Tcw - ref.Tcw).abs().max()) <= 1e-4
    assert torch.equal(got.inliers, ref.inliers)
    assert torch.isfinite(got.chi2).all()


def make_ba_problem(rng, n_cams=6, n_pts=256, n_obs=4, pose_noise=0.02, point_noise=0.05,
                    pix_noise=0.4, outlier_frac=0.08, n_fixed=2, stereo=False):
    """`tests/test_ba.py`'s `make_ba_problem` without JAX: cameras along x
    with a small yaw, points in front, each seen by n_obs random cameras,
    pixel noise, gross outliers and perturbed free cameras and points."""
    from orbslam2_tpu_torch.geometry import se3
    from orbslam2_tpu_torch.solvers.ba import BAProblem

    cams_true = np.stack([
        se3.exp_se3(torch.tensor([0.4 * i, 0.0, 0.0, 0.0, 0.02 * i, 0.0])).numpy()
        for i in range(n_cams)
    ])
    pts_true = np.c_[rng.uniform(-4, 6, n_pts), rng.uniform(-3, 3, n_pts),
                     rng.uniform(6, 14, n_pts)].astype(np.float32)
    obs_cam = np.stack([rng.permutation(n_cams)[:n_obs] for _ in range(n_pts)]).astype(np.int64)
    Ts = cams_true[obs_cam]
    pc = np.einsum("poij,pj->poi", Ts[..., :3, :3], pts_true) + Ts[..., :3, 3]
    u = 480.0 * pc[..., 0] / pc[..., 2] + 319.5
    v = 480.0 * pc[..., 1] / pc[..., 2] + 239.5
    obs_uv = np.stack([u, v], -1) + rng.normal(0, pix_noise, (n_pts, n_obs, 2))
    obs_ur = (u - 48.0 / pc[..., 2]) if stereo else np.full((n_pts, n_obs), -1.0)
    n_out = int(n_pts * n_obs * outlier_frac)
    pi, oi = rng.integers(0, n_pts, n_out), rng.integers(0, n_obs, n_out)
    obs_uv[pi, oi] += rng.uniform(15, 60, (n_out, 2)) * np.sign(rng.normal(size=(n_out, 2)))
    cam_init = cams_true.copy()
    for i in range(n_fixed, n_cams):
        cam_init[i] = se3.exp_se3(torch.from_numpy(rng.normal(0, pose_noise, 6).astype(np.float32))
                                  ).numpy() @ cam_init[i]
    pts_init = pts_true + rng.normal(0, point_noise, pts_true.shape)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    return BAProblem(
        cam_Tcw=t(cam_init), cam_free=t(np.arange(n_cams) >= n_fixed, torch.bool),
        points=t(pts_init), point_valid=torch.ones(n_pts, dtype=torch.bool),
        obs_cam=t(obs_cam, torch.int64), obs_uv=t(obs_uv), obs_ur=t(obs_ur),
        obs_inv_sigma2=torch.ones(n_pts, n_obs), obs_valid=t(pc[..., 2] > 0.5, torch.bool),
    )


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_bundle_adjust_card_matches_cpu(device, stereo):
    """Two-phase BA on the card against the same call on the CPU: poses to
    1e-4 and points with two or more inlier edges to 1e-3 m (float32; the
    card sums the reduced system with atomics, in another order), equal
    inlier sets."""
    from orbslam2_tpu_torch import config
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.solvers import ba

    cam = config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
    prob = make_ba_problem(np.random.default_rng(7), stereo=stereo)
    cpu = ba.two_phase_bundle_adjust(prob, Intrinsics.from_config(cam, "cpu"))
    gpu = ba.two_phase_bundle_adjust(ba.BAProblem(*(x.to(device) for x in prob)),
                                     Intrinsics.from_config(cam, device))
    assert float((gpu.cam_Tcw.cpu() - cpu.cam_Tcw).abs().max()) <= 1e-4
    assert torch.equal(gpu.obs_inlier.cpu(), cpu.obs_inlier)
    err = torch.linalg.norm(gpu.points.cpu() - cpu.points, dim=-1)
    assert float(err[cpu.obs_inlier.sum(1) >= 2].max()) <= 1e-3


def test_keyframe_full_step_launches_k1(device):
    """A keyframe step on the card matches descriptors through K1: one
    launch per triangulation neighbour and fuse target, and one for the
    union fused back into the keyframe."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.pipeline import fused
    from chip_smoke import run_session, small_config

    cfg = small_config()
    slam, _, _ = run_session(cfg, 6, device, mapping=True)
    t = slam.tracker
    before = kernels.launch_counts["hamming"]
    kf_id, *_ = fused.keyframe_full_step(
        slam.map, t.last_frame, t.last_Tcw, t.last_point_idx,
        slam.local_mapper.probation_window(), t.K, t._params,
        slam.local_mapper.level_sigma2, slam.local_mapper.inv_sigma2, **slam._kf_kwargs(),
    )
    assert kf_id >= 0 and bool(slam.map.kf_valid[kf_id])
    assert kernels.launch_counts["hamming"] - before >= 5 + 5 + 1


def _stereo_match_on(dev):
    """`compute_stereo_matches` of one forward-dolly pair at 640x480, its
    features extracted on the CPU, the pyramids and the match on `dev`."""
    from orbslam2_tpu_torch import config, synthetic
    from orbslam2_tpu_torch.ops import orb, pyramid, stereo

    cam = config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
    orb_cfg = config.OrbConfig(num_features=1000, feature_slots=1024)
    left, right, _ = synthetic.textured_sequence(n_frames=4, kind="forward", cam=cam).stereo(2)
    ext = orb.OrbExtractor(orb_cfg)
    fl, fr = ext(torch.from_numpy(left)), ext(torch.from_numpy(right))
    sf = torch.tensor(pyramid.level_scales(orb_cfg))
    to = [x.to(dev) for x in (fl.xy, fl.octave, fl.desc, fl.valid,
                              fr.xy, fr.octave, fr.desc, fr.valid)]
    lv = [pyramid.build_pyramid(torch.from_numpy(im).to(dev), orb_cfg) for im in (left, right)]
    args = (*to, *lv, sf.to(dev), torch.tensor(48.0, device=dev), torch.tensor(480.0, device=dev))
    return lambda: stereo.compute_stereo_matches(*args)


def test_stereo_matches_card_matches_cpu(device):
    """`compute_stereo_matches` on the card against the CPU for the same
    images and features, with one K1 launch: the matched sets equal up to
    1 % at the median threshold, u_right to 1e-3 px, depth to 1e-4."""
    from orbslam2_tpu_torch import kernels

    cpu = _stereo_match_on("cpu")()
    match = _stereo_match_on(device)
    before = kernels.launch_counts["hamming"]
    gpu = match()
    assert kernels.launch_counts["hamming"] == before + 1
    gd, cd = gpu.depth.cpu(), cpu.depth
    assert int(((gd > 0) != (cd > 0)).sum()) <= 0.01 * int((cd > 0).sum())
    both = (gd > 0) & (cd > 0)
    assert int(both.sum()) > 300
    assert float((gpu.u_right.cpu() - cpu.u_right)[both].abs().max()) <= 1e-3
    assert float(((gd - cd).abs() / cd)[both].max()) <= 1e-4


def test_stereo_match_and_median_read_nothing_on_host(device):
    """After a first call, which builds K1 and the pyramid's level table,
    the stereo match and the mono initialization's median run with no
    host read (CUDA sync debug mode raises on one)."""
    from orbslam2_tpu_torch.pipeline.tracking import _nanmedian

    match = _stereo_match_on(device)
    match()
    x = torch.tensor([3.0, float("nan"), 1.0, 2.0, 5.0, float("nan")], device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = match()
        med = _nanmedian(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int((out.depth > 0).sum()) > 300
    assert float(med) == 2.5


def test_initialize_card_matches_cpu(device):
    """The H/F initializer on the card against the CPU, fed the same
    minimal sets: success, model and inliers equal, T21 to 1e-4."""
    from orbslam2_tpu_torch import config
    from orbslam2_tpu_torch.geometry import camera, se3
    from orbslam2_tpu_torch.solvers import initializer

    cam = config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5)
    rng = np.random.default_rng(0)
    n = 300
    pw = torch.from_numpy(np.c_[rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                                rng.uniform(3, 10, n)].astype(np.float32))
    T2 = se3.exp_se3(torch.tensor([0.3, 0.02, 0.05, 0.01, 0.03, 0.005]))
    K = camera.Intrinsics.from_config(cam, "cpu")
    uv1 = camera.project(pw, K) + torch.from_numpy(rng.normal(0, 0.5, (n, 2)).astype(np.float32))
    uv2 = camera.project(se3.apply(T2, pw), K)
    uv2[:40] += torch.from_numpy(rng.uniform(30, 90, (40, 2)).astype(np.float32))
    mask = torch.ones(n, dtype=torch.bool)
    samples = initializer.draw_init_samples(mask, 256, torch.Generator().manual_seed(0))
    cpu = initializer.initialize(uv1, uv2, mask, K, samples)
    gpu = initializer.initialize(uv1.to(device), uv2.to(device), mask.to(device),
                                 camera.Intrinsics.from_config(cam, device), samples)
    assert bool(cpu.success) and bool(gpu.success)
    assert bool(gpu.used_homography) == bool(cpu.used_homography)
    assert torch.equal(gpu.good.cpu(), cpu.good)
    assert float((gpu.T21.cpu() - cpu.T21).abs().max()) <= 1e-4


def test_pose_kernel_all_mono_matches_plain(device):
    """K2 on observations that are all 2-D (ur < 0), the monocular path's
    case: Tcw to 1e-4 and equal inlier sets."""
    from orbslam2_tpu_torch import config, kernels
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.solvers import cuda_pose_opt, pose_opt
    from chip_smoke import make_pose_problem

    K = Intrinsics.from_config(config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0),
                               device)
    obs = make_pose_problem(np.random.default_rng(3), device, n=1280, n_real=900, stereo_frac=0.0)
    assert bool((obs.ur < 0).all())
    for rounds, iters in [(2, 6), (3, 6), (4, 6)]:
        before = kernels.launch_counts["pose_gn"]
        got = cuda_pose_opt.pose_optimize_fast(torch.eye(4, device=device), obs, K, rounds, iters)
        assert kernels.launch_counts["pose_gn"] == before + 1
        ref = pose_opt.pose_optimize(torch.eye(4, device=device), obs, K, rounds, iters)
        assert float((got.Tcw - ref.Tcw).abs().max()) <= 1e-4
        assert torch.equal(got.inliers, ref.inliers)


def _pose_case(device, n=1024, n_real=700, stereo_frac=0.6):
    from orbslam2_tpu_torch import config
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from chip_smoke import make_pose_problem

    K = Intrinsics.from_config(config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0),
                               device)
    obs = make_pose_problem(np.random.default_rng(5), device, n=n, n_real=n_real,
                            stereo_frac=stereo_frac)
    return torch.eye(4, device=device), obs, K


@pytest.mark.parametrize("n,n_real,stereo_frac", [(1024, 700, 0.6), (1280, 900, 0.0), (200, 150, 0.5)])
def test_pose_kernel_counts_inliers_and_repeats(device, n, n_real, stereo_frac):
    """K2 writes `num_inliers` itself: a 0-d tensor of the plain version's
    dtype equal to `inliers.sum()`; two launches on the same inputs give
    bit-equal outputs (no atomics, one fixed summation order)."""
    from orbslam2_tpu_torch.solvers import cuda_pose_opt, pose_opt

    T0, obs, K = _pose_case(device, n, n_real, stereo_frac)
    first = cuda_pose_opt.pose_optimize_cuda(T0, obs, K, rounds=4, iters=6)
    second = cuda_pose_opt.pose_optimize_cuda(T0, obs, K, rounds=4, iters=6)
    ref = pose_opt.pose_optimize(T0, obs, K, rounds=4, iters=6)
    assert first.num_inliers.dtype == ref.num_inliers.dtype and first.num_inliers.dim() == 0
    assert int(first.num_inliers) == int(first.inliers.sum()) == int(ref.num_inliers)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# seconds of host time inside the profiler's window before the launch and
# after the synchronisation (see `_profiled_pose_launch`)
PROFILER_MARGIN_S = 0.05


def _profiled_pose_launch() -> None:
    """The profiled half of `test_pose_kernel_wrapper_reads_nothing_on_host`,
    run in a fresh process: one K2 call with no profiler (it builds and
    loads the library), then one under `torch.profiler` with CUDA sync
    debug mode on; prints the launch count's rise, the CUDA kernel events
    and the inlier counts as one JSON line.

    `torch.profiler` drops a kernel whose timestamp, converted to the host's
    clock, falls outside its capture window (Kineto counts it as
    out-of-range), and on an NVIDIA H100 that conversion was off by up to
    tens of milliseconds in a process that had run for a while: the one-kernel window then came
    back empty though the kernel ran (`tools/profiler_events_trace.py`). So
    the session runs in a fresh process, and the window opens
    PROFILER_MARGIN_S before the launch and closes that long after it."""
    import json
    import time

    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.solvers import cuda_pose_opt

    T0, obs, K = _pose_case(torch.device("cuda"))
    cuda_pose_opt.pose_optimize_fast(T0, obs, K, 4, 6)
    torch.cuda.synchronize()
    before = kernels.launch_counts["pose_gn"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_MARGIN_S)
        torch.cuda.set_sync_debug_mode("error")
        try:
            r = cuda_pose_opt.pose_optimize_fast(T0, obs, K, 4, 6)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
    print(json.dumps({
        "launches": kernels.launch_counts["pose_gn"] - before,
        "kernels_run": [e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA],
        "num_inliers": int(r.num_inliers), "inliers_sum": int(r.inliers.sum())}))


def test_pose_kernel_wrapper_reads_nothing_on_host(device):
    """After a first call, which builds and loads the library, the K2
    wrapper launches its kernel with no host read (CUDA sync debug mode
    raises on one) and nothing but the kernel: no stack of the intrinsics,
    no separate sum of the inliers. The profiled call runs in a fresh
    process (`_profiled_pose_launch` says why)."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(here))
    # loaded by path: a `tests` package installed elsewhere would shadow the
    # repo's `tests` directory, which is no package
    code = ("import importlib.util, sys; sys.path.insert(0, sys.argv[1]); "
            "spec = importlib.util.spec_from_file_location('card_tests', sys.argv[2]); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            "m._profiled_pose_launch()")
    out = subprocess.run([sys.executable, "-c", code, root, here], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["launches"] == 1
    kernels_run = r["kernels_run"]
    assert kernels_run and all("pose_gn" in name for name in kernels_run), kernels_run
    assert r["num_inliers"] == r["inliers_sum"]


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_bundle_adjust_card_is_deterministic(device, stereo):
    """The reduced system is summed in a fixed order (sorted targets, a
    segment sum), not with atomics: the same BA twice on the card gives
    bit-equal poses, points and costs."""
    from orbslam2_tpu_torch import config
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.solvers import ba

    K = Intrinsics.from_config(config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5,
                                                   bf=48.0), device)
    prob = ba.BAProblem(*(x.to(device) for x in make_ba_problem(np.random.default_rng(7),
                                                                stereo=stereo)))
    first = ba.two_phase_bundle_adjust(prob, K)
    second = ba.two_phase_bundle_adjust(prob, K)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# -- relocalization and loop closing ---------------------------------------


def _builtin_vocab(device):
    from pathlib import Path

    from orbslam2_tpu_torch import convert
    from orbslam2_tpu_torch.vocab import bow

    z = np.load(Path(__file__).resolve().parent.parent / "orbslam2_tpu_torch" / "data" / "vocab.npz")
    return (bow.Codebook(coarse=convert.to_tensor(z["coarse"], device),
                         fine=convert.to_tensor(z["fine"], device)),
            convert.to_tensor(z["idf"], device))


@pytest.fixture(scope="module")
def loop_map():
    """The 320x240 dolly (18 frames, mapping and loop closing on) tracked on
    the CPU, and its map: the same map on the card and the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import run_session, small_config

    slam, seq, _ = run_session(small_config(), 18, torch.device("cpu"), mapping=True,
                               loop_closing=True)
    return slam, seq


def _map_on(slam, device):
    from orbslam2_tpu_torch import convert

    return convert.map_state_from_numpy(convert.map_state_to_numpy(slam.map), device)


def test_bow_and_query_card_match_cpu(device):
    """The shipped two-level vocabulary: the same word of every descriptor
    (so the same integer counts), vectors within 1e-6 and the same query
    candidates, card against CPU; one BoW assignment launches K1 once."""
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.vocab import bow
    from orbslam2_tpu_torch.vocab.database import _query

    rng = np.random.default_rng(0)
    cb_g, idf_g = _builtin_vocab(device)
    cb_c, idf_c = _builtin_vocab("cpu")
    K, S = 12, 1024
    desc = torch.from_numpy(rng.integers(0, 2**32, (K, S, 8), dtype=np.uint32).view(np.int32))
    valid = torch.from_numpy(rng.random((K, S)) < 0.8)
    before = kernels.launch_counts["hamming"]
    ids_g = bow.word_ids(desc[0].to(device), cb_g)
    assert kernels.launch_counts["hamming"] == before + 1
    assert torch.equal(ids_g.cpu(), bow.word_ids(desc[0], cb_c))
    rows_g = torch.stack([bow.bow_vector(desc[k].to(device), valid[k].to(device), cb_g, idf_g)
                          for k in range(K)])
    rows_c = torch.stack([bow.bow_vector(desc[k], valid[k], cb_c, idf_c) for k in range(K)])
    assert float((rows_g.cpu() - rows_c).abs().max()) < 1e-6
    covis = torch.from_numpy(rng.integers(0, 4, (K, K)).astype(np.int32) * 10)
    present = torch.from_numpy(rng.random(K) < 0.9)
    exclude = torch.zeros(K, dtype=torch.bool)
    exclude[0] = True
    q_c = _query(rows_c, present, rows_c[0], exclude, 0.0, covis, 8)
    q_g = _query(rows_g, present.to(device), rows_g[0], exclude.to(device), 0.0, covis.to(device), 8)
    assert torch.equal(q_g[0].cpu(), q_c[0]) and torch.equal(q_g[1].cpu(), q_c[1])


def test_verify_candidate_card_matches_cpu(device, loop_map):
    """The fused Sim3 verification of keyframe 2 against keyframe 0 on the
    same map with the same draw: equal stats, match and guided sets, S12
    within 1e-4."""
    from orbslam2_tpu_torch.pipeline import loop_closing as lc
    from orbslam2_tpu_torch.solvers import horn

    slam, _ = loop_map
    sf = slam.loop_closer.scale_factors
    ls2 = slam.loop_closer.level_sigma2

    def run(dev):
        return lc._verify_candidate(
            _map_on(slam, dev), 2, 0,
            lambda m: horn.draw_sim3_samples(m, 128, torch.Generator().manual_seed(5)),
            slam.builder.K if dev == "cpu" else _intrinsics_on(slam.builder.K, dev),
            sf.to(dev), ls2.to(dev))

    got, ref = run(device), run("cpu")
    assert torch.equal(got[0].cpu(), ref[0]), (got[0], ref[0])
    assert float((got[1].cpu() - ref[1]).abs().max()) <= 1e-4
    for a, b in zip(got[2:], ref[2:]):
        assert torch.equal(a.cpu(), b)


def _intrinsics_on(K, device):
    return type(K)(*(x.to(device) for x in K))


def test_dense_pose_graph_card_matches_cpu(device):
    from chip_smoke import ring_problem
    from orbslam2_tpu_torch.solvers import pose_graph

    got = pose_graph.optimize_pose_graph(ring_problem(device, 24, 15), iters=20)
    ref = pose_graph.optimize_pose_graph(ring_problem("cpu", 24, 15), iters=20)
    assert float((got.cpu() - ref).abs().max()) <= 1e-4
    again = pose_graph.optimize_pose_graph(ring_problem(device, 24, 15), iters=20)
    assert torch.equal(got, again)


def test_pcg_pose_graph_card_matches_cpu(device):
    """The essential graph's PCG solve at 160 keyframes, past the loop
    closer's `pose_graph_dense_max_k` (128), with the loop closer's 20
    iterations of 64 CG steps: the card within 1e-4 of the CPU, each
    quaternion compared up to its sign (vertex 80 lies at pi about z,
    where q and -q rest on a rounding residue)."""
    from chip_smoke import packs_gap, ring_problem
    from orbslam2_tpu_torch.config import SolverConfig
    from orbslam2_tpu_torch.solvers import pose_graph

    sc = SolverConfig()
    assert 160 > sc.pose_graph_dense_max_k
    got = pose_graph.optimize_pose_graph_pcg(ring_problem(device, 160, 80), iters=sc.pose_graph_iters,
                                             cg_iters=sc.pose_graph_cg_iters)
    ref = pose_graph.optimize_pose_graph_pcg(ring_problem("cpu", 160, 80), iters=sc.pose_graph_iters,
                                             cg_iters=sc.pose_graph_cg_iters)
    assert torch.isfinite(got).all()
    assert packs_gap(got, ref) <= 1e-4
    assert packs_gap(ref, ring_problem("cpu", 160, 80).vertices) > 1e-3


def test_global_ba_slice_chains_repeat_bitwise(device, loop_map):
    """Two chains of global-BA slices over the same snapshot problem on the
    card give equal bits (fixed-order segment sums, no atomics)."""
    from orbslam2_tpu_torch.pipeline import local_mapping as lm
    from orbslam2_tpu_torch.solvers import ba

    slam, _ = loop_map
    lc = slam.loop_closer
    st = _map_on(slam, device)
    K = _intrinsics_on(slam.builder.K, device)
    prob, *_ = lm.build_global_ba_problem(st, lc.inv_sigma2.to(device),
                                          max_points=st.capacity_mp, obs_slots=st.obs_slots)

    def chain():
        cam, pts, lam = prob.cam_Tcw, prob.points, torch.tensor(1e-4, device=device)
        for _ in range(3):
            cam, pts, lam, cost = ba.bundle_adjust_slice(prob, K, cam, pts, lam, iters=2,
                                                         use_kernel=True)
        return cam, pts, lam, cost

    first, second = chain(), chain()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert torch.isfinite(first[0]).all() and torch.isfinite(first[1]).all()


def test_relocalize_reads_only_the_reference_host_reads(device, loop_map):
    """`Tracker.relocalize` on the card (a LOST tracker, frame 10, the
    map's database) under CUDA sync debug mode: every synchronising
    operation is one of the reference's host reads (`tracking._host`, and
    the reference pose's pull on success)."""
    import traceback
    import warnings

    from orbslam2_tpu_torch.pipeline import tracking
    from orbslam2_tpu_torch.pipeline.system import System
    from chip_smoke import small_config

    slam, seq = loop_map
    sys_g = System(small_config(), device=device)
    sys_g.map = _map_on(slam, device)
    sys_g.tracker.map = sys_g.map
    sys_g.tracker.state = tracking.TrackState.LOST
    sys_g._ensure_loop_closer(0)
    db = sys_g.loop_closer.db
    db.vectors.copy_(slam.loop_closer.db.vectors.to(device))
    db.present.copy_(slam.loop_closer.db.present.to(device))
    img, depth = (torch.from_numpy(x).to(device) for x in seq.frame(10))
    frame = sys_g.builder.rgbd(img, depth, 10 / 30.0)
    frame.xy.sum().item()  # the frame is built before the window
    reads = [0]
    host = tracking._host

    def counted(*xs):
        reads[0] += len(xs)
        return host(*xs)

    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            here = [f"{f.filename.split('/')[-1]}:{f.lineno} {f.name}"
                    for f in traceback.extract_stack()[:-1] if "orbslam2_tpu_torch" in f.filename]
            syncs.append(here[-3:])

    tracking._host = counted
    try:
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ok = sys_g.tracker.relocalize(frame, db)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        tracking._host = host
    assert ok
    if len(syncs) != reads[0] + 1:
        pytest.fail(f"{len(syncs)} synchronising operations, {reads[0]} host reads + 1:\n"
                    + "\n".join(" <- ".join(reversed(s)) for s in syncs))


def test_train_codebook_card_matches_cpu(device):
    """The session-trained vocabulary's k-medians (K1 assignments, integer
    counts) gives the same words on the card as on the CPU from the same
    seeds, and its draw picks the same seeds on both."""
    from orbslam2_tpu_torch.vocab import bow

    rng = np.random.default_rng(2)
    desc = torch.from_numpy(rng.integers(0, 2**32, (2048, 8), dtype=np.uint32).view(np.int32))
    valid = torch.from_numpy(rng.random(2048) < 0.9)
    seeds_c = bow.draw_codebook_seeds(valid, 256, 6, torch.Generator().manual_seed(1))
    seeds_g = bow.draw_codebook_seeds(valid.to(device), 256, 6, torch.Generator().manual_seed(1))
    assert torch.equal(seeds_g.cpu(), seeds_c)
    got = bow.train_codebook(desc.to(device), valid.to(device), seeds_g, 256, 6)
    assert torch.equal(got.cpu(), bow.train_codebook(desc, valid, seeds_c, 256, 6))


@pytest.fixture
def world1(device, tmp_path):
    """This process as the one rank of an NCCL group on the card."""
    from orbslam2_tpu_torch.parallel import group

    with group.member(0, 1, str(tmp_path / "store"), device):
        yield device


def test_sharded_solvers_at_world_size_1_match_single_device(world1):
    """Each sharded function at world size 1 on the card against the port's
    single-device solver on the card: the BA's direct solve equal to
    `bundle_adjust` to the bit (its PCG solve within 1e-3 of the truth's
    cameras, as the direct one), both pose-graph modes equal to the
    single-device PCG at bench_scaling.py's K=256, E=8192 (gathered
    blocks laid out otherwise than the single-device solve's take other
    product kernels there, and ended 1.04e-4 off), the BoW query equal to
    `database._query`."""
    from chip_smoke import scaling_bow_query, scaling_pose_graph
    from orbslam2_tpu_torch import config
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.parallel import sharded_ba, sharded_bow, sharded_pose_graph
    from orbslam2_tpu_torch.solvers import ba, pose_graph
    from orbslam2_tpu_torch.vocab import database

    device = world1
    cam = config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
    K = Intrinsics.from_config(cam, device)
    prob = ba.BAProblem(*(x.to(device) for x in make_ba_problem(np.random.default_rng(7))))
    c, p, cost = sharded_ba.sharded_bundle_adjust(prob, K, iters=10)
    single = ba.bundle_adjust(prob, K, iters=10)
    assert torch.equal(c, single.cam_Tcw) and torch.equal(p, single.points)
    assert torch.equal(cost, single.cost)
    c_pcg, _, cost_pcg = sharded_ba.sharded_bundle_adjust(prob, K, iters=10,
                                                          camera_solver="pcg")
    assert float((c_pcg - c).abs().max()) <= 1e-3 and torch.isfinite(cost_pcg)

    gprob = scaling_pose_graph(device)
    ref = pose_graph.optimize_pose_graph_pcg(gprob, iters=2)
    for inner in ("gathered", "stepped"):
        out = sharded_pose_graph.sharded_optimize_pose_graph(gprob, iters=2, inner=inner)
        assert torch.equal(out, ref), inner

    args = scaling_bow_query(device)
    for a, b in zip(sharded_bow.sharded_query(*args), database._query(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inner", ["gathered", "stepped"])
def test_sharded_pose_graph_reads_nothing_on_host(world1, inner):
    """After a first solve, a sharded pose-graph solve at world size 1 runs
    its Gauss-Newton iterations and every CG step with no host read (CUDA
    sync debug mode raises on one): the collectives and the solve are
    one chain on the device."""
    from chip_smoke import ring_problem
    from orbslam2_tpu_torch.parallel import sharded_pose_graph

    gprob = ring_problem(world1, 64, 32)
    sharded_pose_graph.sharded_optimize_pose_graph(gprob, iters=1, cg_iters=4, inner=inner)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sharded_pose_graph.sharded_optimize_pose_graph(gprob, iters=2, cg_iters=16,
                                                             inner=inner)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out).all()
