"""K2's plain PyTorch version against the reference package's
`pose_opt.pose_optimize` on the reference's test problem (noisy pixels,
gross outliers, NaN in padded slots): Tcw to atol 5e-5 and identical
inlier sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraConfig
from orbslam2_tpu.geometry import camera as jcam
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.solvers import pose_opt as jpo
from orbslam2_tpu_torch import convert, kernels
from orbslam2_tpu_torch.geometry import camera as tcam
from orbslam2_tpu_torch.solvers import cuda_pose_opt
from orbslam2_tpu_torch.solvers import pose_opt as tpo

CAM = CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
KJ = jcam.Intrinsics.from_config(CAM)
KT = tcam.Intrinsics.from_config(CAM, device="cpu")


def make_problem(rng, n=1024, n_real=700, noise=0.5, n_out=80, stereo_frac=0.6):
    """The pattern of tests/test_pallas_pose_opt.py, as numpy arrays."""
    pw = np.c_[rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)].astype(np.float32)
    T_true = jse3.exp_se3(jnp.asarray([0.1, -0.05, 0.2, 0.02, -0.03, 0.01], jnp.float32))
    uvr = np.asarray(jcam.project_stereo(jse3.apply(T_true, jnp.asarray(pw)), KJ))
    uv = uvr[:, :2] + rng.normal(0, noise, (n, 2))
    ur = uvr[:, 2] + rng.normal(0, noise, n)
    ur = np.where(rng.random(n) < stereo_frac, ur, -1.0).astype(np.float32)
    out_idx = rng.choice(n_real, n_out, replace=False)
    uv[out_idx] += rng.normal(0, 30, (n_out, 2))
    mask = np.arange(n) < n_real
    uv[~mask] = np.nan
    return {"pw": pw, "uv": uv.astype(np.float32), "ur": ur,
            "inv_sigma2": np.ones(n, np.float32), "mask": mask}


def _run_both(obs_np, rounds, iters):
    ref = jpo.pose_optimize(jse3.identity(), jpo.PoseObservations(**{k: jnp.asarray(v) for k, v in obs_np.items()}),
                            KJ, rounds=rounds, iters=iters)
    got = cuda_pose_opt.pose_optimize_fast(torch.eye(4), convert.pose_observations_from_numpy(obs_np, "cpu"),
                                           KT, rounds=rounds, iters=iters)
    return ref, got


@pytest.mark.parametrize("rounds,iters", [(4, 10), (2, 6), (3, 6), (4, 6)])
def test_plain_matches_reference(rng, rounds, iters):
    ref, got = _run_both(make_problem(rng), rounds, iters)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=5e-5)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 500
    assert torch.isfinite(got.Tcw).all()


def test_plain_matches_reference_unpadded_size(rng):
    ref, got = _run_both(make_problem(rng, n=700, n_real=600, n_out=40), 2, 6)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=5e-5)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))


def test_solve6_spd_matches_reference(rng):
    M = rng.normal(0, 1, (6, 6)).astype(np.float32)
    H = (M @ M.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    ref = np.asarray(jpo.solve6_spd(jnp.asarray(H), jnp.asarray(b)))
    got = tpo.solve6_spd(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(H @ got, b, atol=1e-4)


def test_wrapper_on_cpu_takes_plain_version(rng, monkeypatch):
    monkeypatch.setitem(kernels.launch_counts, "pose_gn", 0)
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("kernel library loaded on CPU"))
    obs = convert.pose_observations_from_numpy(make_problem(rng, n=256, n_real=200, n_out=10), "cpu")
    got = cuda_pose_opt.pose_optimize_fast(torch.eye(4), obs, KT, rounds=2, iters=6)
    ref = tpo.pose_optimize(torch.eye(4), obs, KT, rounds=2, iters=6)
    assert torch.equal(got.Tcw, ref.Tcw)
    assert kernels.launch_counts["pose_gn"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pose_opt.pose_optimize_cuda(torch.eye(4), obs, KT)
