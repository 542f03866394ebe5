"""How far float32 rounding moves the global BA on `stress_scale.py`'s map:
the cost after 0, 1 and 2 Levenberg-Marquardt iterations for the reference
(JAX on the CPU), the port in float32 and the port in float64, on the same
arrays (`orbslam2_tpu_torch.scale.build_arrays`).

    JAX_PLATFORMS=cpu python tools/scale_ba_precision.py [K P]

K keyframes and P points (default 64 4096, the scale test's size; 1024
98304 is the stress's, a few minutes on the CPU, most of it the
reference's).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from orbslam2_tpu.geometry.camera import Intrinsics as JIntrinsics  # noqa: E402
from orbslam2_tpu.pipeline import local_mapping as jlm  # noqa: E402
from orbslam2_tpu.pipeline import loop_closing as jlc  # noqa: E402
from orbslam2_tpu.slam_map import map_state as jms  # noqa: E402
from orbslam2_tpu.solvers import ba as jba  # noqa: E402
from orbslam2_tpu_torch import scale  # noqa: E402
from orbslam2_tpu_torch.geometry.camera import Intrinsics  # noqa: E402
from orbslam2_tpu_torch.pipeline import local_mapping as lm  # noqa: E402
from orbslam2_tpu_torch.solvers import ba  # noqa: E402
from tests.test_torch_longrun import _reference_scale_state  # noqa: E402


def main(K: int = 64, P: int = 4096) -> None:
    S, O = scale.SLOTS, scale.OBS
    cpu = torch.device("cpu")
    st = scale.build_state(K, P, S, O, scale.SEED, cpu)
    scale.graph_stages(st, cpu)
    prob, *_ = lm.build_global_ba_problem(st, torch.ones(8), max_points=st.capacity_mp,
                                          obs_slots=O)
    prob64 = ba.BAProblem(*(x.double() if x.is_floating_point() else x for x in prob))
    js = _reference_scale_state(scale.build_arrays(K, P, S, O, scale.SEED), K, P, S, O)
    js, _ = jms.rebuild_observations(js)
    jprob, *_ = jlm.build_global_ba_problem(jlc.rebuild_covisibility(js),
                                            jnp.ones(8, jnp.float32), max_points=P + 1024,
                                            obs_slots=O)
    for it in (0, 1, 2):
        ref = float(jba.bundle_adjust(jprob, JIntrinsics.from_config(scale.CAMERA), iters=it,
                                      use_kernel=True).cost)
        f32 = float(ba.bundle_adjust(prob, Intrinsics.from_config(scale.CAMERA, cpu),
                                     iters=it).cost)
        f64 = float(ba.bundle_adjust(prob64, Intrinsics.from_config(scale.CAMERA, cpu,
                                                                    dtype=torch.float64),
                                     iters=it).cost)
        print(f"K={K} P={P}, {it} iterations: reference {ref:.9g}, port {f32:.9g}, port float64 "
              f"{f64:.9g}; port - reference {(f32 - ref) / ref:.3e}, reference - float64 "
              f"{(ref - f64) / f64:.3e}, port - float64 {(f32 - f64) / f64:.3e} (relative)",
              flush=True)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
