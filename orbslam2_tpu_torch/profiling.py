"""Tracing and profiling (the port of `orbslam2_tpu.utils.profiling`).

* `StageTimer` — blocking per-stage wall timers with summary statistics.
  A stage's time ends when its device work has: on a CUDA device the timer
  synchronizes it (the reference blocks on its outputs with
  `jax.block_until_ready`).
* `device_trace` — a context manager around `torch.profiler` that writes a
  Chrome trace, viewable in Perfetto or `chrome://tracing`.
* The program's tracer — `span` / `spanned` around the pipeline's stages
  and `count` at its events, off until `enable()`; `take()` hands over
  what was recorded. It never synchronises the card: a span is a pair of
  host clock reads, and its K1 / K2 launches are the deltas of
  `kernels.launch_counts`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Iterator, NamedTuple

import numpy as np
import torch

from orbslam2_tpu_torch import kernels


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


# ---------------------------------------------------------------------------
# the program's tracer
# ---------------------------------------------------------------------------
#
# Off (the default) a span costs one module-level flag check and hands back
# one shared no-op context: no clock read, no profiler range, no record.
# On, each span keeps one `Span` in `_spans`; while a `torch.profiler` is
# recording it also opens the range "orbslam2.<name>", so an exported
# Chrome trace shows the program's stages. Counters are incremented where
# their event happens, from values the host already holds.

class Span(NamedTuple):
    """One closed span. `parent` indexes the enclosing span in the same
    `take()` (-1: a root); `frame_id`, `kf_id` and `cand` are inherited
    from the parent unless the span names its own (-1: none); `k1` / `k2`
    are the K1 / K2 launches made inside it."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    frame_id: int
    kf_id: int
    cand: int
    k1: int
    k2: int


_on = False
_spans: list = []       # a Span's fields, or None while the span is open
_open: list = []        # the open spans, innermost last
_generation = 0         # bumped by take(): a span opened before it is dropped
counters: dict = {}

# the profiler range a span opens; the C++ context manager costs a few us,
# `record_function` (its fallback) tens
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


def now_ns() -> int:
    """The tracer's clock: the wall clock (CLOCK_REALTIME) in ns, the clock
    `torch.profiler` stamps its host events with (Kineto converts its
    approximate TSC clock to Unix-epoch ns), so a span's ends and the
    profiler's ranges, launch calls and converted device times lie on one
    axis. `time.perf_counter_ns` runs on another epoch."""
    return time.time_ns()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "frame_id", "kf_id", "cand", "index", "parent", "generation", "range",
                 "k1", "k2", "start")

    def __init__(self, name, frame_id, kf_id, cand):
        self.name, self.frame_id, self.kf_id, self.cand = name, frame_id, kf_id, cand

    def __enter__(self):
        outer = _open[-1] if _open else None
        if outer is not None:
            if self.frame_id is None:
                self.frame_id = outer.frame_id
            if self.kf_id is None:
                self.kf_id, self.cand = outer.kf_id, outer.cand
        self.frame_id = -1 if self.frame_id is None else self.frame_id
        self.kf_id = -1 if self.kf_id is None else self.kf_id
        self.cand = -1 if self.cand is None else self.cand
        self.parent = outer.index if outer is not None and outer.generation == _generation else -1
        self.generation = _generation
        self.index = len(_spans)
        _spans.append(None)
        _open.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = _Range("orbslam2." + self.name)
            self.range.__enter__()
        self.k1, self.k2 = kernels.launch_counts["hamming"], kernels.launch_counts["pose_gn"]
        self.start = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.pop()
        if self.generation == _generation:
            lc = kernels.launch_counts
            _spans[self.index] = (self.name, self.start, end, self.parent, self.frame_id,
                                  self.kf_id, self.cand, lc["hamming"] - self.k1,
                                  lc["pose_gn"] - self.k2)
        return False


def span(name: str, frame_id: int | None = None, kf_id: int | None = None,
         cand: int | None = None):
    """A context manager that records the stage `name` while the tracer is
    on. `frame_id` (the frame being tracked), `kf_id` and `cand` (a
    verification's keyframe and candidate) default to the enclosing
    span's."""
    if not _on:
        return _NO_SPAN
    return _OpenSpan(name, frame_id, kf_id, cand)


def spanned(name: str):
    """`span(name)` around every call of the decorated function."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _OpenSpan(name, None, None, None):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` (a host value) to the counter `name` while the tracer is on."""
    if _on:
        counters[name] = counters.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> dict:
    """What was recorded since the last `take()`, then cleared: {"spans":
    [Span] in the order they opened, "counters": {name: n}}. A span still
    open is left out (and its children's `parent` is -1)."""
    global _spans, counters, _generation
    spans, _spans = _spans, []
    taken, counters = counters, {}
    _generation += 1
    closed = [Span(*s) for s in spans if s is not None]
    if len(closed) < len(spans):
        moved = {}
        for i, s in enumerate(spans):
            if s is not None:
                moved[i] = len(moved)
        closed = [s._replace(parent=moved.get(s.parent, -1)) for s in closed]
    return {"spans": closed, "counters": taken}
