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


@pytest.mark.parametrize("n,m", [(1024, 1024), (4096, 1024), (100, 300), (1, 1)])
def test_hamming_kernel_matches_plain(device, n, m):
    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.ops import cuda_hamming, hamming

    rng = np.random.default_rng(n + m)
    a = torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)).to(device)
    b = torch.from_numpy(rng.integers(0, 2**32, (m, 8), dtype=np.uint32).view(np.int32)).to(device)
    before = kernels.launch_counts["hamming"]
    got = cuda_hamming.distance_matrix(a, b)
    assert kernels.launch_counts["hamming"] == before + 1
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
