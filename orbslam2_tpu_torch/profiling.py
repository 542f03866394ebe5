"""Tracing and profiling (the port of `orbslam2_tpu.utils.profiling`).

* `StageTimer` — blocking per-stage wall timers with summary statistics.
  A stage's time ends when its device work has: on a CUDA device the timer
  synchronizes it (the reference blocks on its outputs with
  `jax.block_until_ready`).
* `device_trace` — a context manager around `torch.profiler` that writes a
  Chrome trace, viewable in Perfetto or `chrome://tracing`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Wrap callables, or time blocks; each stage's time ends after the
    work it queued on `device` has finished."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.times: dict[str, list[float]] = defaultdict(list)

    def wrap(self, name: str, fn):
        def inner(*args, **kwargs):
            _sync(self.device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(self.device)
            self.times[name].append(time.perf_counter() - t0)
            return out

        return inner

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.times[name].append(time.perf_counter() - t0)

    def summary(self, skip_first: int = 1) -> dict[str, dict[str, float]]:
        out = {}
        for name, vals in self.times.items():
            tail = vals[skip_first:] or vals
            out[name] = {
                "n": len(vals),
                "first_ms": round(vals[0] * 1e3, 2),
                "median_ms": round(float(np.median(tail)) * 1e3, 2),
                "p90_ms": round(float(np.percentile(tail, 90)) * 1e3, 2),
                "total_s": round(float(np.sum(vals)), 3),
            }
        return out


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the host and, where there is one, the CUDA device:
    `with device_trace('/tmp/trace') as prof: ...` writes
    `log_dir/trace.json` (a Chrome trace) on exit; `prof.key_averages()`
    gives the time per operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
