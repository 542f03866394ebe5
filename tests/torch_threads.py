"""CPU threads of the port's tests under pytest-xdist.

Each xdist worker is a process with its own OpenMP pool, by default as
wide as the machine. Several such pools spin against each other between
parallel regions, and the port's CPU sessions, thousands of small ops per
frame, slow several-fold: the tier-1 command (six workers on eight cores)
took 585 s so, and 219 s with one thread per worker. Under xdist each
worker therefore takes an equal share of the cores; a run without xdist
keeps torch's default."""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 0:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
