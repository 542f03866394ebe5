"""The float32 margins behind three of the multi-device slice's parity bars,
measured on the CPU with the reference and the port side by side:

1. BA `direct` on `tests/test_ba.py`'s 0.5 px problem (256 points, 15 LM
   iterations): how far the reference's own cameras move between 1 and 8
   devices, and how far the port's lie from the reference's at 1, 2 and
   8 ranks;
2. the first LM step's camera system on the noiseless problem: the gap
   between the two packages' float32 assemblies, the condition number of
   its damped free block, how far that gap moves the exact (float64)
   solution, and each package's whole first PCG step (48 CG steps) from
   the exact solution of the port's system;
3. `graft_entry.entry()`'s example image: the descriptors that differ
   between the packages' extractions, their orientation gaps, and the
   largest one.

    JAX_PLATFORMS=cpu python tools/parity_margins.py

About a minute and a half; prints one line per reading.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from orbslam2_tpu.config import OrbConfig as RefOrbConfig  # noqa: E402
from orbslam2_tpu.ops import orb as ref_orb  # noqa: E402
from orbslam2_tpu.parallel import sharded_ba as jsba  # noqa: E402
from orbslam2_tpu_torch import convert, graft_entry  # noqa: E402
from orbslam2_tpu_torch.config import OrbConfig  # noqa: E402
from orbslam2_tpu_torch.geometry import se3  # noqa: E402
from orbslam2_tpu_torch.ops.orb import OrbExtractor  # noqa: E402
from orbslam2_tpu_torch.parallel import group, sharded_ba  # noqa: E402
from orbslam2_tpu_torch.solvers import ba  # noqa: E402
from tests.test_ba import K, make_ba_problem  # noqa: E402
from tests.test_torch_loop_solvers import K_T  # noqa: E402


def steps(cam, cam0) -> torch.Tensor:
    """Each camera's update as a twist, log(T T0^-1), float64."""
    T = torch.as_tensor(np.array(cam), dtype=torch.float64)
    T0 = torch.as_tensor(np.array(cam0), dtype=torch.float64)
    return se3.log_se3(T @ torch.linalg.inv(T0))


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def lm_near_ties() -> None:
    _, _, prob = make_ba_problem(np.random.default_rng(0), n_pts=256, n_fixed=2, pix_noise=0.5)
    tprob = convert.ba_problem_from_numpy(prob._asdict(), "cpu")
    ref = {n: np.asarray(jsba.sharded_bundle_adjust(prob, K, jsba.make_points_mesh(n),
                                                    iters=15)[0]) for n in (1, 2, 8)}
    print(f"BA direct, 0.5 px, 15 iterations: the reference's cameras, 1 against 8 devices, "
          f"max gap {np.abs(ref[1] - ref[8]).max():.3e}", flush=True)
    for n in (1, 2, 8):
        with group.Group(n, "cpu") as g:
            cam = g.run(sharded_ba.sharded_bundle_adjust, tprob, K_T, iters=15)[0].numpy()
        print(f"  the port at {n} rank(s) against the reference at {n}: max gap "
              f"{np.abs(cam - ref[n]).max():.3e}", flush=True)


def first_step_conditioning() -> None:
    _, _, prob = make_ba_problem(np.random.default_rng(0), n_pts=256, n_fixed=2)
    tprob = convert.ba_problem_from_numpy(prob._asdict(), "cpu")
    lam = torch.tensor(1e-4)
    terms = ba._edge_terms(tprob.cam_Tcw, tprob.points, tprob, K_T, True)
    S, g_S, _ = ba.reduced_system(*terms[:4], tprob, lam, ba._assembly(tprob))
    S_r, g_r, _, _ = jsba._local_schur(prob, K, jnp.float32(1e-4), jnp.asarray(True))
    S_r, g_r = torch.from_numpy(np.array(S_r)), torch.from_numpy(np.array(g_r))
    free = tprob.cam_free
    exact = ba.solve_cameras(S.double(), g_S.double(), free, lam.double())
    exact_r = ba.solve_cameras(S_r.double(), g_r.double(), free, lam.double())
    C = S.shape[0]
    A = (S.double() * (free[:, None, None, None] & free[None, :, None, None])).permute(
        0, 2, 1, 3).reshape(6 * C, 6 * C)
    keep = free.repeat_interleave(6)
    A = A[keep][:, keep]
    gap_S = float((S - S_r).abs().max() / S.abs().max())
    gap_g = float((g_S - g_r).abs().max() / g_S.abs().max())
    print(f"first step: assemblies apart by {gap_S:.3e} (S) and {gap_g:.3e} (g), relative to "
          f"their largest entry; free block's condition number {float(torch.linalg.cond(A)):.4g};"
          f" exact solutions of the two systems apart by {rel(exact_r, exact):.3e}", flush=True)
    exact_step = steps(se3.exp_se3(exact) @ tprob.cam_Tcw.double(), prob.cam_Tcw)
    for n in (1, 2, 8):
        cam = jsba.sharded_bundle_adjust(prob, K, jsba.make_points_mesh(n), iters=1,
                                         camera_solver="pcg", cg_iters=48)[0]
        print(f"  the reference's first PCG step on {n} device(s) from the exact solution of "
              f"the port's system: {rel(steps(cam, prob.cam_Tcw), exact_step):.3e}", flush=True)
    with group.Group(1, "cpu") as g:
        cam = g.run(sharded_ba.sharded_bundle_adjust, tprob, K_T, iters=1, camera_solver="pcg",
                    cg_iters=48)[0]
    print(f"  the port's, at 1 rank: {rel(steps(cam, prob.cam_Tcw), exact_step):.3e}", flush=True)


def example_descriptors() -> None:
    _, args = graft_entry.entry("cpu")
    image = args[0]
    ref = jax.jit(lambda im: ref_orb.extract(im, RefOrbConfig(num_features=1000,
                                                               feature_slots=1024)))(
        jnp.asarray(image.numpy()))
    got = OrbExtractor(OrbConfig(num_features=1000, feature_slots=1024))(image)
    valid = got.valid.numpy()
    differ = (np.asarray(ref.desc).view(np.int32) != got.desc.numpy()).any(axis=1) & valid
    gap = np.abs(np.asarray(ref.angle) - got.angle.numpy())
    print(f"entry()'s example image: {int(differ.sum())} of {int(valid.sum())} descriptors "
          f"differ (rows {np.flatnonzero(differ).tolist()}, orientation gaps "
          f"{[f'{a:.3e}' for a in gap[differ]]} rad); largest orientation gap "
          f"{gap[valid].max():.3e} rad", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    lm_near_ties()
    first_step_conditioning()
    example_descriptors()
