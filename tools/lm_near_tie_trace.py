"""Each Levenberg-Marquardt step of the sliced global BA, in the
reference and in the port, on one `make_ba_problem` seed: whether the step
was accepted, the cost before it, the candidate's cost, lambda, and the
step's relative margin |new_cost - cost| / cost. A decision the two
packages take differently at a margin within float32 rounding of the cost
sum is a near-tie, not a port fault.

    JAX_PLATFORMS=cpu python tools/lm_near_tie_trace.py SEED [ITERS]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from orbslam2_tpu.geometry import se3 as jse3  # noqa: E402
from orbslam2_tpu.solvers import ba as jba  # noqa: E402
from orbslam2_tpu_torch import convert  # noqa: E402
from orbslam2_tpu_torch.geometry import se3 as tse3  # noqa: E402
from orbslam2_tpu_torch.solvers import ba as tba  # noqa: E402
from tests.test_torch_ba import make_ba_problem  # noqa: E402
from tests.test_torch_loop_solvers import K, K_T  # noqa: E402


def trace(ba, se3, prob, K, cam, pts, lam, clamp, iters, plan=()):
    stereo = prob.obs_ur >= 0
    terms = ba._edge_terms(cam, pts, prob, K, True)
    cost = ba._robust_cost(terms[4], terms[5], True, stereo)
    out = []
    for _ in range(iters):
        r, Jc, Jp, w, _, _ = terms
        dx, dp = ba._build_and_solve(r, Jc, Jp, w, prob, lam, *plan)
        cam_n, pts_n = se3.exp_se3(dx) @ cam, pts + dp
        terms_n = ba._edge_terms(cam_n, pts_n, prob, K, True)
        new = ba._robust_cost(terms_n[4], terms_n[5], True, stereo)
        accept = bool(new < cost)
        out.append((accept, float(cost), float(new), float(lam)))
        if accept:
            cam, pts, cost, terms = cam_n, pts_n, new, terms_n
        lam = clamp(lam * (0.5 if accept else 4.0))
    return out


def main():
    seed = int(sys.argv[1])
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    _, _, prob = make_ba_problem(np.random.default_rng(seed), pose_noise=0.05, point_noise=0.1,
                                 pix_noise=0.5)
    tprob = convert.ba_problem_from_numpy(prob._asdict(), "cpu")
    ref = trace(jba, jse3, prob, K, prob.cam_Tcw, prob.points, jnp.float32(1e-4),
                lambda x: jnp.clip(x, 1e-9, 1e3), iters)
    port = trace(tba, tse3, tprob, K_T, tprob.cam_Tcw, tprob.points, torch.tensor(1e-4),
                 lambda x: torch.clamp(x, 1e-9, 1e3), iters, (tba._assembly(tprob),))
    print(f"seed {seed}, {int(np.asarray(prob.obs_valid).sum())} edges; per step: accept, cost, "
          "new cost, lambda, |new - cost| / cost (reference | port)")
    for i, (a, b) in enumerate(zip(ref, port)):
        m_a, m_b = abs(a[2] - a[1]) / a[1], abs(b[2] - b[1]) / b[1]
        print(i, a, f"{m_a:.3e}", "|", b, f"{m_b:.3e}", "DIFFERENT" if a[0] != b[0] else "")


if __name__ == "__main__":
    main()
