"""The loop-closing solvers of the port against the reference on the same
inputs: Sim(3), Horn and its RANSAC, EPnP RANSAC, the Sim3 optimisation,
the essential-graph solves (dense and PCG), and the time-sliced global
BA with its fold-in. The RANSAC cases feed both packages the reference's
minimal sets (`jax.random.choice` of the key the reference is given).

Tolerances: poses 1e-4, inlier sets exact (with the same sets). Where a
case has a ground truth, the reference's own checks run on the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import sign_aligned
from orbslam2_tpu.config import CameraConfig
from orbslam2_tpu.geometry import camera, se3, sim3
from orbslam2_tpu.solvers import ba as jba
from orbslam2_tpu.solvers import epnp, horn, pose_graph, sim3_opt
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.geometry import sim3 as tsim3
from orbslam2_tpu_torch.solvers import ba as tba
from orbslam2_tpu_torch.solvers import epnp as tepnp
from orbslam2_tpu_torch.solvers import horn as thorn
from orbslam2_tpu_torch.solvers import pose_graph as tpg
from orbslam2_tpu_torch.solvers import sim3_opt as tsim3_opt
from tests.test_torch_ba import make_ba_problem

CAM = CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
K = camera.Intrinsics.from_config(CAM)
K_T = convert.intrinsics_from_numpy({k: np.asarray(v) for k, v in K._asdict().items()}, "cpu")


def t(x):
    return convert.to_tensor(np.asarray(x), "cpu")


def assert_packs_close(got, ref, atol):
    """Packed sim3s [..., 8] = (s, q, t) within `atol`, each port quaternion
    first given the sign of the reference's (`chip_smoke.sign_aligned`: q
    and -q are one rotation)."""
    np.testing.assert_allclose(sign_aligned(got, np.asarray(ref)).numpy(),
                               np.asarray(ref, np.float64), atol=atol)


def ref_samples(key, mask, iters, k):
    """The minimal sets the reference's RANSAC draws from `key`."""
    mask = np.asarray(mask)
    p = jnp.asarray(mask, jnp.float32) / max(int(mask.sum()), 1)
    return t(jax.random.choice(key, mask.shape[0], shape=(iters, k), replace=True, p=p))


# -- Sim(3) --------------------------------------------------------------


def test_sim3_exp_log_compose_match_reference(rng):
    xi = (rng.normal(size=(64, 7)) * 0.5).astype(np.float32)
    xi[:8] *= 1e-4          # the small-angle and small-sigma branches
    xi[8:12, 6] = 0.0
    ref = sim3.exp(jnp.asarray(xi))
    got = tsim3.exp(t(xi))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6)
    np.testing.assert_allclose(tsim3.log(got).numpy(), xi, atol=5e-6)
    np.testing.assert_allclose(tsim3.log(got).numpy(), np.asarray(sim3.log(ref)), atol=2e-6)
    A, B = tsim3.exp(t(xi[:32])), tsim3.exp(t(xi[32:]))
    C = tsim3.compose(A, tsim3.inverse(B))
    Cr = sim3.compose(sim3.exp(jnp.asarray(xi[:32])), sim3.inverse(sim3.exp(jnp.asarray(xi[32:]))))
    assert_packs_close(tsim3.pack(C).numpy(), sim3.pack(Cr), atol=5e-6)
    back = tsim3.unpack(tsim3.pack(C))
    for a, b in zip(C, back):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-6)
    p = t(rng.normal(size=(32, 3)).astype(np.float32))
    np.testing.assert_allclose(tsim3.apply(tsim3.inverse(C), tsim3.apply(C, p)).numpy(),
                               p.numpy(), atol=2e-5)


def test_sim3_log_jacobian_finite_at_identity():
    """The pose graph differentiates log at a zero residual: the Jacobian
    of log(exp(d) o S) at d = 0 is finite and equals the reference's
    `jacfwd`, at identity and elsewhere."""
    packs = np.stack([np.asarray(sim3.pack(sim3.identity())),
                      np.asarray(sim3.pack(sim3.exp(jnp.asarray([0.1, -0.2, 0.3, 0.2, 0.1, -0.3,
                                                                 0.05], jnp.float32))))])
    f = lambda d, sp: sim3.log(sim3.compose(sim3.exp(d), sim3.unpack(sp)))  # noqa: E731
    ref = np.stack([np.asarray(jax.jacfwd(f)(jnp.zeros(7), jnp.asarray(sp))) for sp in packs])
    tp = t(packs)
    got = tsim3.tangent_jacobian(
        lambda d: tsim3.log(tsim3.compose(tsim3.exp(d), tsim3.unpack(tp))), torch.zeros(2, 7))
    assert torch.isfinite(got).all() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.eye(7), atol=1e-5)


# -- Horn (test_loop_solvers.py::TestHorn) -------------------------------


def random_sim3(rng, scale_spread=0.3):
    R = np.asarray(se3.quat_to_rot(jnp.asarray(rng.normal(size=4).astype(np.float32))))
    return float(np.exp(rng.normal() * scale_spread)), R, rng.normal(size=3).astype(np.float32)


@pytest.mark.parametrize("fix_scale", [False, True], ids=["scale", "fixed"])
def test_horn_exact_recovery(rng, fix_scale):
    s, R, tt = random_sim3(rng)
    s = 1.0 if fix_scale else s
    p2 = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    p1 = (s * (p2 @ R.T) + tt).astype(np.float32)
    se, Re, te = thorn.horn_sim3(t(p1), t(p2), torch.ones(50), fix_scale=fix_scale)
    assert float(se) == pytest.approx(s, rel=1e-4)
    np.testing.assert_allclose(Re.numpy(), R, atol=1e-4)
    np.testing.assert_allclose(te.numpy(), tt, atol=1e-3)
    ref = horn.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), jnp.ones(50), fix_scale=fix_scale)
    for a, b in zip(ref, (se, Re, te)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True], ids=["scale", "fixed"])
def test_ransac_sim3_with_outliers(rng, fix_scale):
    N = 120
    pw = np.c_[rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(4, 8, N)].astype(np.float32)
    T1 = np.asarray(se3.identity())
    T2 = np.asarray(se3.exp_se3(jnp.asarray([0.4, 0, 0, 0, 0.05, 0], jnp.float32)))
    s_gt, R_gt = 1.15, np.asarray(se3.exp_so3(jnp.asarray([0.02, 0.3, -0.01])))
    pw2 = ((pw - np.asarray([0.5, -0.2, 0.8])) @ R_gt) / s_gt
    uv1 = np.asarray(camera.project(se3.apply(jnp.asarray(T1), jnp.asarray(pw)), K))
    uv2 = np.asarray(camera.project(se3.apply(jnp.asarray(T2), jnp.asarray(pw2.astype(np.float32))), K))
    pw2[:30] += rng.uniform(0.5, 2.0, (30, 3))
    pw2 = pw2.astype(np.float32)
    key = jax.random.PRNGKey(0)
    mask = np.ones(N, bool)
    ref = horn.ransac_sim3(jnp.asarray(pw), jnp.asarray(pw2), jnp.asarray(mask), jnp.asarray(uv1),
                           jnp.asarray(uv2), jnp.ones(N), jnp.ones(N), jnp.asarray(T1),
                           jnp.asarray(T2), K, key, fix_scale=fix_scale)
    got = thorn.ransac_sim3(t(pw), t(pw2), t(mask), t(uv1), t(uv2), torch.ones(N), torch.ones(N),
                            t(T1), t(T2), K_T, ref_samples(key, mask, 128, 3),
                            fix_scale=fix_scale)
    assert bool(got.success) == bool(ref.success)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers)
    for a, b in ((ref.s, got.s), (ref.R, got.R), (ref.t, got.t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    if not fix_scale:
        inl = got.inliers.numpy()
        assert bool(got.success) and inl[30:].mean() > 0.9 and not inl[:30].any()
        assert int(got.num_inliers) > 80


def test_draw_samples_choose_only_set_entries():
    g = torch.Generator().manual_seed(0)
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[3, 7, 11, 40]] = True
    s = thorn.draw_sim3_samples(mask, 200, g)
    assert s.shape == (200, 3)
    assert set(s.reshape(-1).tolist()) == {3, 7, 11, 40}
    again = thorn.draw_sim3_samples(mask, 200, torch.Generator().manual_seed(0))
    assert torch.equal(s, again)
    none = tepnp.draw_pnp_samples(torch.zeros(9, dtype=torch.bool), 10, g)
    assert none.shape == (10, 6) and int(none.min()) >= 0 and int(none.max()) <= 8


# -- EPnP (tests/test_epnp.py) -------------------------------------------


def make_pnp(rng, n=128, noise=0.0, outliers=0, planar=False):
    if planar:
        pw = np.c_[rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   6.0 + rng.uniform(-0.02, 0.02, n)].astype(np.float32)
        xi = np.asarray([0.3, -0.2, 0.1, 0.4, -0.3, 0.15], np.float32)
    else:
        pw = np.c_[rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)].astype(np.float32)
        xi = np.asarray([0.2, -0.1, 0.3, 0.05, -0.1, 0.08], np.float32)
    Tcw = np.asarray(se3.exp_se3(jnp.asarray(xi)))
    uv = np.array(camera.project(se3.apply(jnp.asarray(Tcw), jnp.asarray(pw)), K))
    if noise:
        uv += rng.normal(0, noise, uv.shape)
    if outliers:
        uv[:outliers] += rng.uniform(25, 80, (outliers, 2)) * np.sign(rng.normal(size=(outliers, 2)))
    return pw, Tcw, uv.astype(np.float32)


# the pose difference (any entry of Tcw) allowed between the port's and
# the reference's EPnP on the noisy cases below: with noise the EPnP pose
# depends on its control points' eigenvector signs, which neither solver
# fixes; the near-planar case moves most
NOISY_POSE_BAR = 0.05


def terr(T, Tgt):
    return np.linalg.norm((np.asarray(T) @ np.linalg.inv(Tgt))[:3, 3])


@pytest.mark.parametrize("case,seed,bar", [
    ("noiseless", 0, 5e-3), ("outliers", 1, 0.05), ("near_planar", 2, 0.05), ("too_few", 0, None),
])
def test_ransac_pnp_matches_reference(rng, case, seed, bar):
    """With the reference's minimal sets: the same success and the same
    inlier set; the pose within 1e-4 where it is determined (noiseless
    matches). On noisy matches an EPnP pose depends on its control points,
    which come from eigenvectors whose signs neither LAPACK nor the port's
    Jacobi solver promise, so the pose is held to the reference's own bar
    against the ground truth and to `NOISY_POSE_BAR` of the reference's."""
    kw = dict(noiseless={}, outliers=dict(noise=0.5, outliers=40),
              near_planar=dict(noise=0.3, planar=True), too_few={})[case]
    pw, Tgt, uv = make_pnp(rng, **kw)
    n = len(pw)
    mask = np.ones(n, bool)
    if case == "too_few":
        mask[5:] = False
    key = jax.random.PRNGKey(seed)
    ref = epnp.ransac_pnp(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(mask), jnp.ones(n), K, key,
                          min_inliers=10)
    got = tepnp.ransac_pnp(t(pw), t(uv), t(mask), torch.ones(n), K_T,
                           ref_samples(key, mask, 256, 6), min_inliers=10)
    assert bool(got.success) == bool(ref.success)
    if case == "too_few":
        assert not bool(got.success)
        return
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    diff = np.abs(got.Tcw.numpy() - np.asarray(ref.Tcw)).max()
    assert diff <= (1e-4 if case == "noiseless" else NOISY_POSE_BAR), diff
    assert terr(got.Tcw, Tgt) < bar
    inl = got.inliers.numpy()
    if case == "outliers":
        assert inl[:40].mean() < 0.2 and inl[40:].mean() > 0.8
    else:
        assert int(got.num_inliers) > 100


# -- Sim3 optimisation ---------------------------------------------------


@pytest.mark.parametrize("fix_scale", [False, True], ids=["scale", "fixed"])
def test_optimize_sim3_matches_reference(rng, fix_scale):
    """A perturbed S12 over noisy pairs with outliers: the same S12 (1e-4)
    and the same inlier set."""
    N = 160
    pc2 = np.c_[rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(3, 8, N)]
    s_gt = 1.0 if fix_scale else 1.1
    R_gt = np.asarray(se3.exp_so3(jnp.asarray([0.02, -0.05, 0.01], jnp.float32)))
    t_gt = np.asarray([0.1, -0.05, 0.2])
    pc1 = s_gt * pc2 @ R_gt.T + t_gt
    uv1 = np.asarray(camera.project(jnp.asarray(pc1, jnp.float32), K)) + rng.normal(0, 0.5, (N, 2))
    uv2 = np.asarray(camera.project(jnp.asarray(pc2, jnp.float32), K)) + rng.normal(0, 0.5, (N, 2))
    uv1[:20] += 40.0
    mask = rng.random(N) < 0.9
    inv1 = np.ones(N, np.float32)
    inv2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, N))).astype(np.float32)
    s0 = np.float32(s_gt * (1.0 if fix_scale else 1.03))
    R0 = np.asarray(se3.exp_so3(jnp.asarray([0.03, -0.04, 0.0], jnp.float32)))
    t0 = (t_gt + 0.05).astype(np.float32)
    f = np.float32
    args = [pc1.astype(f), pc2.astype(f), uv1.astype(f), uv2.astype(f), inv1, inv2, mask]
    ref = sim3_opt.optimize_sim3(jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0),
                                 *map(jnp.asarray, args), K, fix_scale)
    got = tsim3_opt.optimize_sim3(t(s0), t(R0), t(t0), *map(t, args), K_T, fix_scale)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 100
    for a, b in ((ref.s, got.s), (ref.R, got.R), (ref.t, got.t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    assert abs(float(got.s) - s_gt) < 0.01


# -- the essential graph (TestPoseGraph, TestPcgPoseGraph) ----------------


def _chain(rng, Kn, extra_loops, sd):
    gt = np.stack([np.asarray(se3.exp_se3(jnp.asarray(
        [np.cos(2 * np.pi * i / Kn), np.sin(2 * np.pi * i / Kn), 0, 0, 0, 2 * np.pi * i / Kn],
        jnp.float32))) for i in range(Kn)])
    est = gt.copy()
    for i in range(1, Kn):
        est[i] = np.asarray(se3.exp_se3(jnp.asarray(rng.normal(0, sd, 6).astype(np.float32) * i))) @ gt[i]
    ei, ej, meas, w = [], [], [], []

    def add(a, b, weight):
        ei.append(a)
        ej.append(b)
        meas.append(np.asarray(pose_graph.se3_to_pack(jnp.asarray((gt[b] @ np.linalg.inv(gt[a])).astype(np.float32)))))
        w.append(weight)

    for i in range(Kn - 1):
        add(i, i + 1, 1.0)
    add(Kn - 1, 0, 5.0)
    for a, b in extra_loops:
        add(a, b, 1.0)
    prob = pose_graph.PoseGraphProblem(
        vertices=jax.vmap(pose_graph.se3_to_pack)(jnp.asarray(est.astype(np.float32))),
        vertex_valid=jnp.ones(Kn, bool), vertex_fixed=jnp.zeros(Kn, bool).at[0].set(True),
        edge_i=jnp.asarray(ei, jnp.int32), edge_j=jnp.asarray(ej, jnp.int32),
        edge_meas=jnp.asarray(np.stack(meas).astype(np.float32)),
        edge_valid=jnp.ones(len(ei), bool), edge_weight=jnp.asarray(w, jnp.float32))
    return gt, est, prob


def t_prob(prob):
    return tpg.PoseGraphProblem(*(t(x) for x in prob))


def pose_errs(poses, gt):
    return np.asarray([np.linalg.norm(np.asarray(se3.log_se3(jnp.asarray(
        (poses[i] @ np.linalg.inv(gt[i])).astype(np.float32))))) for i in range(len(gt))])


def test_pose_graph_distributes_drift(rng):
    gt, est, prob = _chain(rng, 12, [], 0.01)
    ref = np.asarray(pose_graph.optimize_pose_graph(prob, iters=25))
    out = tpg.optimize_pose_graph(t_prob(prob), iters=25)
    assert_packs_close(out.numpy(), ref, atol=1e-4)
    poses = tpg.pack_to_se3(out).numpy()
    assert pose_errs(poses, gt).max() < 0.25 * pose_errs(est, gt).max()


def test_pose_graph_pcg_matches_dense_and_reference(rng):
    gt, _, prob = _chain(rng, 48, [(5, 29), (12, 40)], 0.002)
    ref = np.asarray(pose_graph.optimize_pose_graph_pcg(prob, iters=15, cg_iters=64))
    out = tpg.optimize_pose_graph_pcg(t_prob(prob), iters=15, cg_iters=64)
    assert_packs_close(out.numpy(), ref, atol=1e-4)
    dense = tpg.optimize_pose_graph(t_prob(prob), iters=15)
    np.testing.assert_allclose(tpg.pack_to_se3(out).numpy(), tpg.pack_to_se3(dense).numpy(),
                               atol=2e-3)
    assert pose_errs(tpg.pack_to_se3(out).numpy(), gt).max() < 0.1


def test_pose_graph_pcg_respects_fixed_and_invalid(rng):
    _, _, prob = _chain(rng, 16, [], 0.002)
    prob = prob._replace(vertex_valid=prob.vertex_valid.at[15].set(False),
                         edge_valid=prob.edge_valid.at[14].set(False).at[15].set(False))
    out = tpg.optimize_pose_graph_pcg(t_prob(prob), iters=5, cg_iters=32).numpy()
    np.testing.assert_allclose(out[0], np.asarray(prob.vertices[0]), atol=1e-7)
    np.testing.assert_allclose(out[15], np.asarray(prob.vertices[15]), atol=1e-7)
    assert np.isfinite(out).all()
    ref = np.asarray(pose_graph.optimize_pose_graph_pcg(prob, iters=5, cg_iters=32))
    assert_packs_close(out, ref, atol=1e-4)


def test_pack_of_a_half_turn_matches_reference():
    """Rotations of exactly pi (qw = 0, where the sign of q rests on a
    rounding residue) and near it, about each axis and a skew one: both
    packages' packs give the same rotation, and agree up to q's sign."""
    axes = np.asarray([[0, 0, 1], [1, 0, 0], [0, 1, 0], [1, 2, -2]], np.float64)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = [np.pi, np.pi - 1e-4, 2 * np.pi * 6 / 12]
    Ts = np.stack([np.asarray(se3.exp_se3(jnp.asarray(np.r_[0.1, -0.2, 0.3, a * ax], jnp.float32)))
                   for ax in axes for a in angles]).astype(np.float32)
    ref = np.asarray(jax.vmap(pose_graph.se3_to_pack)(jnp.asarray(Ts)))
    got = tpg.se3_to_pack(t(Ts)).numpy()
    assert_packs_close(got, ref, atol=1e-5)
    np.testing.assert_allclose(tpg.pack_to_se3(t(got)).numpy(),
                               np.asarray(jax.vmap(pose_graph.pack_to_se3)(jnp.asarray(ref))),
                               atol=1e-5)


def test_remap_points(rng):
    old = t(np.stack([np.asarray(pose_graph.se3_to_pack(se3.identity()))] * 4))
    T = se3.exp_se3(jnp.asarray([0.5, 0, 0, 0, 0, 0], jnp.float32))
    new = old.clone()
    new[2] = t(pose_graph.se3_to_pack(T))
    pts = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    out = tpg.remap_points(t(pts), torch.full((10,), 2, dtype=torch.int32), old, new)
    np.testing.assert_allclose(out.numpy(), np.asarray(se3.apply(se3.inverse(T), jnp.asarray(pts))),
                               atol=1e-5)


# -- the time-sliced global BA (tests/test_async_gba.py) -----------------


# LM iterations over which each seed's port is held to the reference: seed
# 11's fifth step is a near-tie (|new_cost - cost| 1.5e-6 and 2.4e-6 of a
# 317 cost summed over 1024 float32 edges, where the two packages' costs
# already differ by 2e-6), which the reference rejects and the port takes;
# after it the poses sit 1.6e-4 apart for good. Seed 7's steps after its
# near-ties are too small to move the poses by 1e-4.
REF_LM_ITERS = {7: 8, 11: 4}


@pytest.mark.parametrize("seed", [7, 11])
def test_slice_chain_matches_monolithic(seed):
    """Slices of `bundle_adjust_slice` chain to what one `bundle_adjust`
    gives in the port over 8 iterations, and the port's monolithic run
    matches the reference's over the iterations before any near-tie in
    the LM accept test (poses 1e-4, points max(1e-3 m, 5e-4 z^2)). Seeds
    as `test_torch_ba.py` (seed 3's problem holds an LM near-tie)."""
    _, _, prob = make_ba_problem(np.random.default_rng(seed), pose_noise=0.05, point_noise=0.1,
                                 pix_noise=0.5)
    tprob = convert.ba_problem_from_numpy(prob._asdict(), "cpu")
    mono = tba.bundle_adjust(tprob, K_T, iters=8, use_kernel=True)
    cam, pts, lam = tprob.cam_Tcw, tprob.points, torch.tensor(1e-4)
    for _ in range(4):
        cam, pts, lam, _ = tba.bundle_adjust_slice(tprob, K_T, cam, pts, lam, iters=2,
                                                   use_kernel=True)
    np.testing.assert_allclose(cam.numpy(), mono.cam_Tcw.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pts.numpy(), mono.points.numpy(), rtol=0, atol=1e-4)
    iters = REF_LM_ITERS[seed]
    ref = jba.bundle_adjust(prob, K, iters=iters, use_kernel=True)
    if iters != 8:
        mono = tba.bundle_adjust(tprob, K_T, iters=iters, use_kernel=True)
    cam, pts = mono.cam_Tcw, mono.points
    np.testing.assert_allclose(cam.numpy(), np.asarray(ref.cam_Tcw), atol=1e-4)
    z = np.asarray(ref.points)[:, 2]
    bar = np.maximum(1e-3, 5e-4 * z * z)
    assert (np.abs(pts.numpy() - np.asarray(ref.points)).max(-1) <= bar).all()


def _fold_in_case():
    """tests/test_async_gba.py's map: six snapshot keyframes with distinct
    corrections, two keyframes and a point made after the snapshot, and a
    recycled point slot."""
    from orbslam2_tpu.config import MapConfig, OrbConfig
    from orbslam2_tpu.slam_map import map_state as ms

    Kcap, P, n_kf, n_pt = 16, 128, 6, 40
    st = ms.allocate(MapConfig(max_keyframes=Kcap, max_points=P), OrbConfig(), obs_slots=4)
    rng = np.random.default_rng(0)
    kf_T = np.tile(np.eye(4, dtype=np.float32), (Kcap, 1, 1))
    for i in range(n_kf):
        kf_T[i] = np.asarray(se3.exp_se3(jnp.asarray(np.r_[0.3 * i, 0, 0, 0, 0.02 * i, 0].astype(np.float32))))
    kf_valid = np.zeros(Kcap, bool)
    kf_valid[:n_kf] = True
    parent = np.full(Kcap, -1, np.int32)
    parent[1:n_kf] = np.arange(n_kf - 1)
    frame_id = np.full(Kcap, -1, np.int32)
    frame_id[:n_kf] = np.arange(n_kf) * 3
    mp_pos = np.zeros((P, 3), np.float32)
    mp_pos[:n_pt] = rng.uniform(-3, 3, (n_pt, 3))
    mp_valid = np.zeros(P, bool)
    mp_valid[:n_pt] = True
    mp_ref = np.full(P, -1, np.int32)
    mp_ref[:n_pt] = rng.integers(0, n_kf, n_pt)
    mp_first = mp_ref.copy()
    snap = dict(kf_frame_id=frame_id.copy(), kf_valid=kf_valid.copy(), mp_first=mp_first[:64].copy())
    cam_opt = kf_T.copy()
    for i in range(Kcap):
        Di = np.asarray(se3.exp_se3(jnp.asarray(np.r_[0.1 + 0.03 * i, -0.05, 0.2, 0.0, 0.01 * i, 0.03].astype(np.float32))))
        cam_opt[i] = cam_opt[i] @ np.linalg.inv(Di)
    D = np.asarray(se3.exp_se3(jnp.asarray(np.r_[0.1, -0.05, 0.2, 0.0, 0.0, 0.03].astype(np.float32))))
    pt_opt = (mp_pos[:64] @ D[:3, :3].T + D[:3, 3]).astype(np.float32)
    T6 = np.asarray(se3.exp_se3(jnp.asarray(np.r_[1.8, 0, 0, 0, 0.1, 0].astype(np.float32))))
    T7 = np.asarray(se3.exp_se3(jnp.asarray(np.r_[2.1, 0, 0, 0, 0.12, 0].astype(np.float32))))
    kf_T[6], kf_T[7] = T6, T7
    kf_valid[6] = kf_valid[7] = True
    parent[6], parent[7] = 5, 6
    frame_id[6], frame_id[7] = 30, 33
    mp_pos[70] = (1.0, 2.0, 3.0)
    mp_valid[70] = True
    mp_ref[70] = mp_first[70] = 7
    mp_first[5] = mp_ref[5] = 7
    live = st._replace(kf_Tcw=jnp.asarray(kf_T), kf_valid=jnp.asarray(kf_valid),
                       kf_parent=jnp.asarray(parent), kf_frame_id=jnp.asarray(frame_id),
                       mp_pos=jnp.asarray(mp_pos), mp_valid=jnp.asarray(mp_valid),
                       mp_ref_kf=jnp.asarray(mp_ref), mp_first_kf=jnp.asarray(mp_first))
    return live, cam_opt, pt_opt, snap, T6, T7


def test_fold_in_propagates_new_keyframes_and_points():
    from orbslam2_tpu.pipeline.loop_closing import _gba_fold_in
    from orbslam2_tpu_torch.pipeline import loop_closing as tlc

    live, cam_opt, pt_opt, snap, T6, T7 = _fold_in_case()
    pts = np.arange(64, dtype=np.int32)
    pt_ok = np.asarray(live.mp_valid)[:64].copy()
    pt_ok[5] = True
    ref = _gba_fold_in(live, jnp.asarray(cam_opt), jnp.asarray(pt_opt), jnp.asarray(pts),
                       jnp.asarray(pt_ok), jnp.asarray(snap["kf_frame_id"]),
                       jnp.asarray(snap["kf_valid"]), jnp.asarray(snap["mp_first"]))
    st = convert.map_state_from_numpy(
        {k: np.asarray(v) for k, v in live._asdict().items()}, "cpu")
    tlc._gba_fold_in(st, t(cam_opt), t(pt_opt), t(pts), t(pt_ok), t(snap["kf_frame_id"]),
                     t(snap["kf_valid"]), t(snap["mp_first"]))
    np.testing.assert_allclose(st.kf_Tcw.numpy(), np.asarray(ref.kf_Tcw), atol=1e-5)
    np.testing.assert_allclose(st.mp_pos.numpy(), np.asarray(ref.mp_pos), atol=1e-5)
    # the reference test's own checks
    out_T = st.kf_Tcw.numpy()
    np.testing.assert_allclose(out_T[:6], cam_opt[:6], atol=1e-5)
    T6_new = T6 @ np.linalg.inv(np.asarray(live.kf_Tcw)[5]) @ cam_opt[5]
    np.testing.assert_allclose(out_T[6], T6_new, atol=1e-5)
    T7_new = T7 @ np.linalg.inv(T6) @ T6_new
    np.testing.assert_allclose(out_T[7], T7_new, atol=1e-5)
    out_p = st.mp_pos.numpy()
    keep = np.arange(64) < 40
    keep[5] = False
    np.testing.assert_allclose(out_p[:64][keep], pt_opt[keep], atol=1e-5)
    pc = T7[:3, :3] @ np.asarray((1.0, 2.0, 3.0)) + T7[:3, 3]
    inv = np.linalg.inv(T7_new)
    np.testing.assert_allclose(out_p[70], inv[:3, :3] @ pc + inv[:3, 3], atol=1e-4)
    assert not np.allclose(out_p[5], pt_opt[5], atol=1e-6)
