"""Sim(3) pose-graph optimisation with the edges sharded over a process
group.

Port of `orbslam2_tpu.parallel.sharded_pose_graph`. A Gauss-Newton
iteration's expensive term is the per-edge forward-mode Jacobian sweep;
each rank runs it over its block of edges. Two inner solves:

* `inner="gathered"`: one all-gather per iteration of the [E, 49+49+7]
  payload (Ji, Jj, the weighted residual), then the PCG runs on every
  rank over all the edges, with no collective. The gather keeps the edge
  order, so the result is `solvers.pose_graph.optimize_pose_graph_pcg`'s;
* `inner="stepped"`: the edge blocks stay local; the block diagonal and
  the gradient are all-reduced once per iteration and every CG step
  all-reduces the [K, 7] product.

Neither reads a value back to the host: a solve is one chain of launches
and collectives.
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch.parallel import group
from orbslam2_tpu_torch.solvers import pose_graph as pg


def sharded_optimize_pose_graph(prob: pg.PoseGraphProblem, iters: int = 20, cg_iters: int = 64,
                                inner: str = "gathered") -> torch.Tensor:
    """Edge-sharded Gauss-Newton with a matrix-free block-Jacobi PCG inner
    solve, called in every rank of the group with the whole problem. The
    edge count must be a multiple of the group size (`pad_edges`). Returns
    the optimised packed sim3 vertices [K, 8] on every rank."""
    if inner not in ("gathered", "stepped"):
        raise ValueError(f"inner must be 'gathered' or 'stepped', not {inner!r}")
    K = prob.vertices.shape[0]
    free = prob.vertex_valid & ~prob.vertex_fixed
    mine = group.rows(prob.edge_i.shape[0])
    ei, ej = prob.edge_i[mine], prob.edge_j[mine]
    local = (ei, ej, prob.edge_meas[mine], prob.edge_valid[mine], prob.edge_weight[mine])
    if inner == "gathered":
        plan = pg.incidence(prob.edge_i, prob.edge_j, K)
    else:
        plan = pg.incidence(ei, ej, K)
    verts = prob.vertices
    for _ in range(iters):
        rw, Ji, Jj = pg.edge_jacobians(verts, *local, prob.vertex_fixed)
        if inner == "gathered":
            payload = group.all_gather(torch.cat([Ji.reshape(-1, 49), Jj.reshape(-1, 49), rw],
                                                 dim=1))
            Ji = _laid_out_as(payload[:, :49].reshape(-1, 7, 7), Ji)
            Jj = _laid_out_as(payload[:, 49:98].reshape(-1, 7, 7), Jj)
            D, g = pg.assemble_diag_g(Ji, Jj, plan, _laid_out_as(payload[:, 98:], rw))
            dx = pg.pcg_solve(Ji, Jj, prob.edge_i, prob.edge_j, plan, D, g, free, cg_iters)
        else:
            D, g = pg.assemble_diag_g(Ji, Jj, plan, rw)
            dx = pg.pcg_solve(Ji, Jj, ei, ej, plan, group.psum(D), group.psum(g), free,
                              cg_iters, reduce=group.psum)
        verts = pg.apply_update(verts, dx)
    return verts


def _laid_out_as(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`x` with its dimensions in `ref`'s memory order. `edge_jacobians`
    gives Jacobians stored basis-major (strides (7, 1, 7E)); on the card
    the batched products choose their kernel, and so their bits, by the
    operands' layout, so the gathered blocks must be laid out as the
    single-device solve's are to give its result."""
    order = sorted(range(ref.dim()), key=lambda d: -ref.stride(d))
    return x.permute(order).contiguous().permute([order.index(d) for d in range(ref.dim())])


def pad_edges(prob: pg.PoseGraphProblem, n_ranks: int) -> pg.PoseGraphProblem:
    """The problem with its edge arrays padded to a multiple of `n_ranks`
    by disabled edges (vertex 0 to itself, identity measurement, weight 0);
    the problem itself when no padding is needed."""
    pad = (-prob.edge_i.shape[0]) % n_ranks
    if pad == 0:
        return prob
    dev = prob.edge_i.device
    zi = torch.zeros(pad, dtype=prob.edge_i.dtype, device=dev)
    eye = pg.se3_to_pack(torch.eye(4, dtype=prob.edge_meas.dtype, device=dev))
    return prob._replace(
        edge_i=torch.cat([prob.edge_i, zi]),
        edge_j=torch.cat([prob.edge_j, zi]),
        edge_meas=torch.cat([prob.edge_meas, eye.expand(pad, -1)]),
        edge_valid=torch.cat([prob.edge_valid, torch.zeros(pad, dtype=torch.bool, device=dev)]),
        edge_weight=torch.cat([prob.edge_weight,
                               torch.zeros(pad, dtype=prob.edge_weight.dtype, device=dev)]),
    )
