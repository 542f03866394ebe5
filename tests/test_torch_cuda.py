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
