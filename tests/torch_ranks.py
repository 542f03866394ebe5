"""Functions the port's parallel tests run in the ranks of a group.

The ranks import this module by name, so it imports only torch and the
port: a rank that imported a test module would load JAX and the
reference package."""

import torch

from orbslam2_tpu_torch.parallel import group, sharded_ba


def pcg_of_rank0_system(S, g_S, free, lam, cg_iters: int):
    """`sharded_ba.solve_cameras_pcg` of the reduced system (S, g_S) held
    by rank 0 alone: the other ranks hold zeros, so the group's sum is
    the system to the bit."""
    if group.axis_index() != 0:
        S, g_S = torch.zeros_like(S), torch.zeros_like(g_S)
    return sharded_ba.solve_cameras_pcg(S, g_S, free, lam, cg_iters)
