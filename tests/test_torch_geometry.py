"""Parity of the port's SE(3) and camera geometry with the reference
package on the same inputs (atol 1e-5, float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import CameraConfig
from orbslam2_tpu.geometry import camera as jcam
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu_torch.geometry import camera as tcam
from orbslam2_tpu_torch.geometry import se3 as tse3

ATOL = 1e-5
DIST_CAM = CameraConfig(fx=480.0, fy=470.0, cx=319.5, cy=239.5, k1=-0.2, k2=0.05,
                        p1=1e-3, p2=-2e-3, k3=0.01, bf=48.0)


def _twists(rng, n=16, scale=0.5):
    xi = rng.normal(0, scale, (n, 6)).astype(np.float32)
    xi[0] = 0.0                      # identity
    xi[1, 3:] = [1e-4, 0.0, 0.0]     # small-angle branch
    xi[2, 3:] = [0.0, 3.1, 0.0]      # near pi
    return xi


def _same(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol)


@pytest.mark.parametrize("name", ["exp_se3", "log_se3", "inverse", "camera_center",
                                  "rot_to_quat", "normalize_rotation", "exp_so3", "log_so3"])
def test_se3_matches_reference(rng, name):
    xi = _twists(rng)
    T_j = jse3.exp_se3(jnp.asarray(xi))
    T_t = tse3.exp_se3(torch.from_numpy(xi))
    if name == "exp_se3":
        _same(T_j, T_t)
    elif name == "log_se3":
        _same(jse3.log_se3(T_j), tse3.log_se3(torch.from_numpy(np.array(T_j))), atol=1e-4)
    elif name == "exp_so3":
        _same(jse3.exp_so3(jnp.asarray(xi[:, 3:])), tse3.exp_so3(torch.from_numpy(xi[:, 3:])))
    elif name == "log_so3":
        R = np.asarray(T_j)[:, :3, :3]
        _same(jse3.log_so3(jnp.asarray(R)), tse3.log_so3(torch.from_numpy(R)), atol=1e-4)
    else:
        T = np.asarray(T_j)
        if name in ("rot_to_quat", "normalize_rotation"):
            T = T[:, :3, :3]
        _same(getattr(jse3, name)(jnp.asarray(T)), getattr(tse3, name)(torch.from_numpy(T)))


def test_apply_hat_vee_quat(rng):
    xi = _twists(rng)
    T = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    p = rng.normal(0, 3, (16, 3)).astype(np.float32)
    _same(jse3.apply(jnp.asarray(T), jnp.asarray(p)), tse3.apply(torch.from_numpy(T), torch.from_numpy(p)))
    W = np.asarray(jse3.hat(jnp.asarray(p)))
    _same(W, tse3.hat(torch.from_numpy(p)))
    _same(jse3.vee(jnp.asarray(W)), tse3.vee(torch.from_numpy(W)))
    q = rng.normal(0, 1, (16, 4)).astype(np.float32)
    _same(jse3.quat_to_rot(jnp.asarray(q)), tse3.quat_to_rot(torch.from_numpy(q)))


def test_log_so3_jacfwd_finite_at_identity():
    """Forward-mode derivative of log_so3 at R = I must be finite: an
    exactly satisfied pose-graph edge sits there."""
    def f(w):
        return tse3.log_so3(tse3.exp_so3(w))

    J = torch.func.jacfwd(f)(torch.zeros(3))
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(J.numpy(), np.eye(3), atol=1e-5)


def test_camera_matches_reference(rng):
    Kj = jcam.Intrinsics.from_config(DIST_CAM)
    Kt = tcam.Intrinsics.from_config(DIST_CAM, device="cpu")
    np.testing.assert_allclose(np.asarray(Kj.K), Kt.K.numpy(), atol=ATOL)
    pc = np.c_[rng.uniform(-2, 2, 64), rng.uniform(-1, 1, 64), rng.uniform(0.5, 8, 64)].astype(np.float32)
    for distort in (False, True):
        np.testing.assert_allclose(
            np.asarray(jcam.project(jnp.asarray(pc), Kj, distort=distort)),
            tcam.project(torch.from_numpy(pc), Kt, distort=distort).numpy(), atol=1e-3,
        )  # pixels of magnitude ~1e3: 1e-3 is float32 rounding
    uv = np.c_[rng.uniform(0, 640, 64), rng.uniform(0, 480, 64)].astype(np.float32)
    depth = rng.uniform(0.5, 8, 64).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jcam.backproject(jnp.asarray(uv), jnp.asarray(depth), Kj)),
        tcam.backproject(torch.from_numpy(uv), torch.from_numpy(depth), Kt).numpy(), atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(jcam.undistort_pixels(jnp.asarray(uv), Kj)),
        tcam.undistort_pixels(torch.from_numpy(uv), Kt).numpy(), atol=1e-3,
    )


@pytest.mark.parametrize("cam", [DIST_CAM, CameraConfig()], ids=["distorted", "pinhole"])
def test_image_bounds_match_reference(cam):
    np.testing.assert_allclose(jcam.compute_image_bounds(cam), tcam.compute_image_bounds(cam),
                               atol=1e-3)
