"""Sim(3) pose-graph ("essential graph") optimisation.

Port of `orbslam2_tpu.solvers.pose_graph` (ORB-SLAM2's
Optimizer::OptimizeEssentialGraph): 7-DoF Sim3 vertices per keyframe;
edges from loop closures, the spanning tree and strong covisibilities;
Gauss-Newton with tangent-space updates; then Sim3 -> SE3 recovery
([R, t/s]) and landmark re-mapping.

The edge residual e = log(S_meas_ji o S_i o S_j^-1) and its forward-mode
Jacobians are batched over the edges (`sim3.tangent_jacobian`). Two inner
solvers share them:

* `optimize_pose_graph`: the dense [7K, 7K] normal equations and a direct
  solve, for loop-neighbourhood sizes;
* `optimize_pose_graph_pcg`: matrix-free block-Jacobi preconditioned CG,
  for long graphs.

The reference accumulates edges into vertices with scatter-adds and, on
the PCG path, one-hot incidence matmuls (a TPU workaround). Here every
accumulation is a fixed-order segment sum (`ba._segments`), so a solve on
the card gives the same bits every time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_tpu_torch.geometry import sim3
from orbslam2_tpu_torch.solvers.ba import _segment_sum, _segments


class PoseGraphProblem(NamedTuple):
    vertices: torch.Tensor      # [K, 8] packed sim3 S_iw (world -> cam i)
    vertex_valid: torch.Tensor  # [K] bool
    vertex_fixed: torch.Tensor  # [K] bool (the loop keyframe is fixed)
    edge_i: torch.Tensor        # [E] int
    edge_j: torch.Tensor        # [E] int
    edge_meas: torch.Tensor     # [E, 8] packed S_ji measurement (cam i -> cam j)
    edge_valid: torch.Tensor    # [E] bool
    edge_weight: torch.Tensor   # [E] float (1.0 normal, boost for loop edges)


def _edge_residual(delta_i, delta_j, Si_pack, Sj_pack, meas_pack):
    """e = log(S_meas_ji o (exp(di) o S_i) o (exp(dj) o S_j)^-1), [E, 7]."""
    Si = sim3.compose(sim3.exp(delta_i), sim3.unpack(Si_pack))
    Sj = sim3.compose(sim3.exp(delta_j), sim3.unpack(Sj_pack))
    err = sim3.compose(sim3.compose(sim3.unpack(meas_pack), Si), sim3.inverse(Sj))
    return sim3.log(err)


def edge_jacobians(verts, edge_i, edge_j, edge_meas, edge_valid, edge_weight, vertex_fixed):
    """Per-edge weighted residuals and Jacobian blocks (rw [E, 7], Ji
    [E, 7, 7], Jj [E, 7, 7]), gated so padding and fixed contributions are
    exactly zero."""
    Si_p = verts[edge_i.to(torch.int64)]
    Sj_p = verts[edge_j.to(torch.int64)]
    zero = torch.zeros(edge_i.shape + (7,), dtype=verts.dtype, device=verts.device)
    r = _edge_residual(zero, zero, Si_p, Sj_p, edge_meas)
    Ji = sim3.tangent_jacobian(lambda d: _edge_residual(d, zero, Si_p, Sj_p, edge_meas), zero)
    Jj = sim3.tangent_jacobian(lambda d: _edge_residual(zero, d, Si_p, Sj_p, edge_meas), zero)
    w = torch.where(edge_valid, edge_weight, 0.0)
    wf_i = (w * ~vertex_fixed[edge_i.to(torch.int64)])[:, None, None]
    wf_j = (w * ~vertex_fixed[edge_j.to(torch.int64)])[:, None, None]
    # gate with where, not a product: a disabled padding edge (i == j,
    # identity measurement) may have a non-finite Jacobian, and NaN * 0
    # stays NaN
    Ji = torch.where(wf_i > 0, Ji * wf_i, 0.0)
    Jj = torch.where(wf_j > 0, Jj * wf_j, 0.0)
    rw = torch.where(w[:, None] > 0, r * w[:, None], 0.0)
    return rw, Ji, Jj


def _system_plan(edge_i, edge_j, K: int):
    """The segment sums of the dense normal equations: the [K, K] block
    targets of JiTJi, JjTJj, JiTJj and JjTJi (in that order, edges in
    order within each), and the [K] targets of the gradient terms."""
    ii, jj = edge_i.to(torch.int64), edge_j.to(torch.int64)
    blocks = torch.cat([ii * K + ii, jj * K + jj, ii * K + jj, jj * K + ii])
    return _segments(blocks, K * K), _segments(torch.cat([ii, jj]), K)


def edge_system(verts, edge_i, edge_j, edge_meas, edge_valid, edge_weight, vertex_fixed, K: int):
    """Assemble the dense Gauss-Newton normal equations (H [K, K, 7, 7],
    g [K, 7]) from a batch of Sim3 edges."""
    rw, Ji, Jj = edge_jacobians(verts, edge_i, edge_j, edge_meas, edge_valid, edge_weight,
                                vertex_fixed)
    blocks, grads = _system_plan(edge_i, edge_j, K)
    Hij = torch.einsum("eai,eaj->eij", Ji, Jj)
    H = _segment_sum(torch.cat([torch.einsum("eai,eaj->eij", Ji, Ji),
                                torch.einsum("eai,eaj->eij", Jj, Jj),
                                Hij, Hij.transpose(-1, -2)]), blocks).view(K, K, 7, 7)
    g = _segment_sum(torch.cat([torch.einsum("eai,ea->ei", Ji, rw),
                                torch.einsum("eai,ea->ei", Jj, rw)]), grads)
    return H, g


def damp_and_solve(H, g, free):
    """Mask fixed and invalid vertices, add trace-scaled damping, solve
    densely. Returns the tangent update dx [K, 7]."""
    K = g.shape[0]
    eye7 = torch.eye(7, dtype=H.dtype, device=H.device)
    H = H * (free[:, None, None, None] & free[None, :, None, None])
    diag = torch.arange(K, device=H.device)
    Hd = H[diag, diag]
    tr = torch.diagonal(Hd, dim1=-2, dim2=-1).sum(-1)
    H[diag, diag] = Hd + torch.where(
        free[:, None, None],
        1e-6 * eye7 * torch.clamp(tr[:, None, None] / 7.0, min=1e-6) + 1e-8 * eye7,
        eye7,
    )
    g = g * free[:, None]
    A = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
    # solve_ex: `solve` would read its status back to the host to raise on
    # a singular system; a failed solve is caught by the finite check
    dx = torch.linalg.solve_ex(A, -g.reshape(7 * K)).result.reshape(K, 7)
    return torch.where(free[:, None] & torch.all(torch.isfinite(dx), -1, keepdim=True), dx, 0.0)


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20) -> torch.Tensor:
    """Returns the optimised packed sim3 vertices [K, 8]."""
    K = prob.vertices.shape[0]
    free = prob.vertex_valid & ~prob.vertex_fixed
    verts = prob.vertices
    for _ in range(iters):
        H, g = edge_system(verts, prob.edge_i, prob.edge_j, prob.edge_meas, prob.edge_valid,
                           prob.edge_weight, prob.vertex_fixed, K)
        verts = apply_update(verts, damp_and_solve(H, g, free))
    return verts


# ---------------------------------------------------------------------------
# matrix-free preconditioned CG
# ---------------------------------------------------------------------------


def incidence(edge_i, edge_j, K: int):
    """The edge -> vertex accumulation of the PCG path: one segment sum of
    the Ji terms (into edge_i) then the Jj terms (into edge_j). Stands for
    the reference's one-hot incidence matrices."""
    return _segments(torch.cat([edge_i, edge_j]).to(torch.int64), K)


def assemble_diag_g(Ji, Jj, plan, rw):
    """Block diagonal of H and the gradient from per-edge Jacobians:
    (D [K, 7, 7], g [K, 7])."""
    D = _segment_sum(torch.cat([torch.einsum("eai,eaj->eij", Ji, Ji),
                                torch.einsum("eai,eaj->eij", Jj, Jj)]), plan)
    g = _segment_sum(torch.cat([torch.einsum("eai,ea->ei", Ji, rw),
                                torch.einsum("eai,ea->ei", Jj, rw)]), plan)
    return D, g


def block_jacobi_precond(D, free):
    """Damped block-Jacobi preconditioner (M_inv [K, 7, 7], damp [K]):
    `damp` is the scalar added to each free vertex's diagonal (the
    trace-scaled rule of `damp_and_solve`); fixed and invalid vertices get
    an identity block."""
    eye7 = torch.eye(7, dtype=D.dtype, device=D.device)
    tr = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1)
    damp = torch.where(free, 1e-6 * torch.clamp(tr / 7.0, min=1e-6) + 1e-8, 1.0)
    M = torch.where(free[:, None, None], D, 0.0) + damp[:, None, None] * eye7
    L = torch.linalg.cholesky_ex(M).L
    ok = torch.all(torch.isfinite(L.reshape(L.shape[0], -1)), dim=-1)[:, None, None]
    L = torch.where(ok, L, eye7)
    y = torch.linalg.solve_triangular(L, eye7.expand(M.shape), upper=False)
    M_inv = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return torch.where(ok, M_inv, eye7), damp


def pcg_solve(Ji, Jj, edge_i, edge_j, plan, D, g, free, cg_iters: int, reduce=None):
    """Solve H dx = -g by preconditioned CG without forming H. `reduce`
    sums the partial [K, 7] products of edge-sharded ranks
    (`parallel.group.psum`); None when this call holds every edge.
    Returns dx [K, 7]."""
    M_inv, damp = block_jacobi_precond(D, free)
    fm = free[:, None]
    ei, ej = edge_i.to(torch.int64), edge_j.to(torch.int64)

    def matvec(x):
        xw = torch.where(fm, x, 0.0)
        t = torch.einsum("eab,eb->ea", Ji, xw[ei]) + torch.einsum("eab,eb->ea", Jj, xw[ej])
        y = _segment_sum(torch.cat([torch.einsum("eab,ea->eb", Ji, t),
                                    torch.einsum("eab,ea->eb", Jj, t)]), plan)
        if reduce is not None:
            y = reduce(y)
        return torch.where(fm, y + damp[:, None] * x, 0.0)

    def precond(r):
        return torch.where(fm, torch.einsum("kab,kb->ka", M_inv, r), 0.0)

    eps = 1e-20
    b = torch.where(fm, -g, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alive = (rz > eps) & (pAp > eps)
        alpha = torch.where(alive, rz / torch.clamp(pAp, min=eps), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(alive, rz_new / torch.clamp(rz, min=eps), 0.0)
        p = torch.where(alive, z + beta * p, p)
        rz = torch.where(alive, rz_new, 0.0)
    return torch.where(fm & torch.all(torch.isfinite(x), -1, keepdim=True), x, 0.0)


def optimize_pose_graph_pcg(prob: PoseGraphProblem, iters: int = 20,
                            cg_iters: int = 64) -> torch.Tensor:
    """Gauss-Newton with a matrix-free block-Jacobi PCG inner solve:
    O(iters * cg_iters * E * 49) instead of O(iters * (7K)^3). Returns the
    optimised packed sim3 vertices [K, 8]."""
    free = prob.vertex_valid & ~prob.vertex_fixed
    K = prob.vertices.shape[0]
    plan = incidence(prob.edge_i, prob.edge_j, K)
    verts = prob.vertices
    for _ in range(iters):
        rw, Ji, Jj = edge_jacobians(verts, prob.edge_i, prob.edge_j, prob.edge_meas,
                                    prob.edge_valid, prob.edge_weight, prob.vertex_fixed)
        D, g = assemble_diag_g(Ji, Jj, plan, rw)
        verts = apply_update(verts, pcg_solve(Ji, Jj, prob.edge_i, prob.edge_j, plan, D, g,
                                              free, cg_iters))
    return verts


def apply_update(verts, dx):
    return sim3.pack(sim3.compose(sim3.exp(dx), sim3.unpack(verts)))


def se3_to_pack(Tcw: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> packed sim3 with s = 1."""
    return sim3.pack(sim3.from_se3(Tcw))


def pack_to_se3(packed: torch.Tensor) -> torch.Tensor:
    """Packed sim3 -> SE3 with the scale folded into the translation."""
    return sim3.to_se3(sim3.unpack(packed))


def remap_points(points, ref_kf, old_pack, new_pack) -> torch.Tensor:
    """Carry landmarks through their reference keyframe's correction:
    p' = S_new^-1(S_old(p))."""
    K = old_pack.shape[0]
    ref = torch.clamp(ref_kf, 0, K - 1).to(torch.int64)
    S_old = sim3.unpack(old_pack[ref])
    S_new = sim3.unpack(new_pack[ref])
    return sim3.apply(sim3.inverse(S_new), sim3.apply(S_old, points))
