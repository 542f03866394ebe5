"""What the hand-written kernels rely on, checked on the CPU.

K1 (`csrc/hamming.cu`) computes d = (256 - <sa, sb>) / 2 on the int8
tensor cores, with s = 1 - 2 bit and a k -> bit map chosen so that each
4-byte group of a k-step (an A fragment register, a 4-byte word of an
expanded B row) takes bits p, p + 8, p + 16, p + 24 of one word. The
emulation below builds the ±1 operands with that map from signed int32
words and holds the result to the reference's `distance_matrix` and
`distance_matrix_mxu`. K2 (`csrc/pose_gn.cu`) reduces its 27 sums with a
warp reduce-scatter, reads the intrinsics packed in `Intrinsics.pinhole`
and writes `num_inliers` as the plain version returns it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from orbslam2_tpu.config import CameraConfig
from orbslam2_tpu.ops import hamming as jham
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.geometry.camera import Intrinsics
from orbslam2_tpu_torch.solvers import pose_opt as tpo


def k1_bit_of_column() -> np.ndarray:
    """For each of a k-step's 32 columns, the bit of the word that
    `expand_pm1` puts there: register half h of lane group t holds columns
    16 h + 4 t + i (byte i), from bit p + 8 i with p = t + 4 h."""
    c = np.arange(32)
    h, t, i = c // 16, (c % 16) // 4, c % 4
    return t + 4 * h + 8 * i


def k1_operand(words: np.ndarray) -> np.ndarray:
    """[N, 8] int32 words -> [N, 256] int64 of ±1 as the kernel's
    fragments hold them: word s is k-step s; -1 where the bit is set."""
    u = words.view(np.uint32).astype(np.int64)
    bits = (u[:, :, None] >> k1_bit_of_column()[None, None, :]) & 1
    return (1 - 2 * bits).reshape(words.shape[0], 256)


def k1_emulated(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    dot = k1_operand(a) @ k1_operand(b).T
    assert np.all(dot % 2 == 0)  # 256 terms of ±1: the halving is exact
    return (256 - dot) // 2


def test_k1_column_map_is_a_permutation():
    assert sorted(k1_bit_of_column().tolist()) == list(range(32))


SPECIAL = [0, -1, -2**31, 2**31 - 1, 1]
words = hnp.arrays(np.int32, st.tuples(st.integers(1, 24), st.just(8)),
                   elements=st.one_of(st.sampled_from(SPECIAL), st.integers(-2**31, 2**31 - 1)))


@settings(max_examples=60, deadline=None, database=None)
@given(a=words, b=words)
def test_k1_pm1_identity_matches_reference(a, b):
    """Signed int32 words (the port's layout of the reference's uint32
    bits), sign bit included: the emulated tensor-core formulation equals
    the reference's XOR + popcount and its ±1 matmul."""
    got = k1_emulated(a, b)
    ja, jb = jnp.asarray(a.view(np.uint32)), jnp.asarray(b.view(np.uint32))
    np.testing.assert_array_equal(got, np.asarray(jham.distance_matrix(ja, jb)))
    np.testing.assert_array_equal(got, np.asarray(jham.distance_matrix_mxu(ja, jb)))


def test_k1_extremes():
    ones = np.full((2, 8), -1, np.int32)
    zeros = np.zeros((3, 8), np.int32)
    np.testing.assert_array_equal(k1_emulated(ones, zeros), np.full((2, 3), 256))
    np.testing.assert_array_equal(k1_emulated(ones, ones), np.zeros((2, 2)))
    sign = np.full((1, 8), -2**31, np.int32)
    np.testing.assert_array_equal(k1_emulated(sign, zeros), [[8, 8, 8]])


def warp_reduce_scatter(v: np.ndarray) -> np.ndarray:
    """`pose_gn.cu:warp_reduce_scatter` over a [32 lanes, 32 entries]
    array: at offset o a lane keeps the half of its entries its lane bit o
    selects and adds its partner's (lane ^ o) copy of that half. Returns
    each lane's final v[0]."""
    v = v.astype(np.float64).copy()
    lanes = np.arange(32)
    o = 16
    while o:
        upper = (lanes & o) != 0
        lo, hi = v[:, :o].copy(), v[:, o:2 * o].copy()
        send = np.where(upper[:, None], lo, hi)
        keep = np.where(upper[:, None], hi, lo)
        v[:, :o] = keep + send[lanes ^ o]
        o >>= 1
    return v[:, 0]


def test_k2_reduce_scatter_leaves_sum_j_on_lane_j(rng):
    v = rng.normal(0, 1, (32, 32))
    v[:, 27:] = 0.0  # the kernel pads its 27 sums to 32
    np.testing.assert_allclose(warp_reduce_scatter(v), v.sum(0), rtol=1e-12, atol=1e-12)


def test_packed_intrinsics_equal_the_fields():
    cam = CameraConfig(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0, k1=0.26, k2=-0.95)
    for K in (Intrinsics.from_config(cam, "cpu"),
              convert.intrinsics_from_numpy(
                  {"fx": 517.3, "fy": 516.5, "cx": 318.6, "cy": 255.3,
                   "dist": np.array([0.26, -0.95, 0.0, 0.0, 0.0]), "bf": 40.0}, "cpu")):
        assert K.pinhole.dtype == torch.float32 and K.pinhole.shape == (5,)
        assert torch.equal(K.pinhole, torch.stack([K.fx, K.fy, K.cx, K.cy, K.bf]))
    assert torch.equal(Intrinsics.from_config(cam, "cpu").pinhole,
                       convert.intrinsics_from_numpy(
                           {"fx": 517.3, "fy": 516.5, "cx": 318.6, "cy": 255.3,
                            "dist": np.zeros(5), "bf": 40.0}, "cpu").pinhole)


@pytest.mark.parametrize("rounds", [0, 2, 4])
def test_plain_num_inliers_is_a_0d_int64(rng, rounds):
    """The kernel writes `num_inliers` into a 0-d int64 tensor: the plain
    version's type, equal to its inlier count."""
    n = 64
    pw = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(4, 8, n)]
    uv = np.c_[480 * pw[:, 0] / pw[:, 2] + 319.5, 480 * pw[:, 1] / pw[:, 2] + 239.5]
    uv[:5] += 40.0
    mask = np.arange(n) < 50
    obs = tpo.PoseObservations(
        pw=torch.tensor(pw, dtype=torch.float32), uv=torch.tensor(uv, dtype=torch.float32),
        ur=torch.full((n,), -1.0), inv_sigma2=torch.ones(n), mask=torch.from_numpy(mask))
    K = Intrinsics.from_config(CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5), "cpu")
    r = tpo.pose_optimize(torch.eye(4), obs, K, rounds=rounds, iters=4)
    assert r.num_inliers.dtype == torch.int64 and r.num_inliers.dim() == 0
    assert int(r.num_inliers) == int(r.inliers.sum())
    assert int(r.num_inliers) == (50 if rounds == 0 else 45)
