"""The traced run's instrumentation, all of it in the benchmark's files.

`Recorder.install` rebinds module attributes of the program so that its
layer entry points run inside spans (a host clock pair and a
`torch.profiler.record_function` range of the same name), and the two
kernel wrappers record each launch's shapes; `uninstall` restores them.
The program's files are not edited. Spans:

* `frame_build`: `fused.rgbd_frame` / `stereo_frame` / `monocular_frame`
  (the frame construction inside `track_frame_rgbd` / `track_frame_stereo`)
  and `System._build_frame` (frames outside steady state);
* `tracking`: `fused.track_step`;
* `mapping`: `fused.keyframe_full_step` and `LocalMapper.after_keyframe`;
* `local_ba`: `fused.local_ba_step` (inside `mapping`);
* `loop_closing`: `loop_closing._verify_candidate`, one Sim3
  verification of a loop candidate (dispatched on one frame, read on the
  next);
* `frame`: one hand-off to pose, recorded by the driver.

`summarize_profile` reduces a `torch.profiler` trace of the profiled pass
to what the device readers need: device intervals, kernel time by name,
the host's waiting CUDA calls and the frame ranges, all on the
profiler's clock.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

# CUDA runtime calls in which the host waits for the device (stream, device
# and event synchronisation, and memory copies), as `bench.host_wait` counts
WAIT_CALLS = {"sync": ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"),
              "memcpy": ("cudaMemcpyAsync", "cudaMemcpy")}
PREFIX = "slambench."
KERNEL_NAMES = {"k1": "hamming_kernel", "k2": "pose_gn_kernel"}


class Recorder:
    """Spans and kernel launches of one traced run. `label` tags what is
    recorded ("spans": the pass the host-time readers read; "profiled":
    the pass under the profiler)."""

    def __init__(self):
        self.spans: list = []      # (label, name, t0_ns, t1_ns)
        self.k1: list = []         # (label, n, m)
        self.k2: list = []         # (label, n, edges tensor, rounds, iters)
        self.label = None
        self.profile: dict | None = None
        self._restore: list = []

    def _spanned(self, name: str, fn):
        rec = self

        def wrapper(*args, **kwargs):
            if rec.label is None:
                return fn(*args, **kwargs)
            t0 = time.perf_counter_ns()
            with torch.profiler.record_function(PREFIX + name):
                out = fn(*args, **kwargs)
            rec.spans.append((rec.label, name, t0, time.perf_counter_ns()))
            return out

        return wrapper

    def frame(self):
        """A context manager for one frame's hand-off to pose."""
        return _FrameSpan(self)

    def _rebind(self, owner, attr: str, new) -> None:
        self._restore.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def install(self) -> None:
        from orbslam2_tpu_torch.ops import cuda_hamming
        from orbslam2_tpu_torch.pipeline import fused, loop_closing
        from orbslam2_tpu_torch.pipeline.local_mapping import LocalMapper
        from orbslam2_tpu_torch.pipeline.system import System
        from orbslam2_tpu_torch.solvers import cuda_pose_opt

        for attr in ("rgbd_frame", "stereo_frame", "monocular_frame"):
            self._rebind(fused, attr, self._spanned("frame_build", getattr(fused, attr)))
        self._rebind(System, "_build_frame", self._spanned("frame_build", System._build_frame))
        self._rebind(fused, "track_step", self._spanned("tracking", fused.track_step))
        self._rebind(fused, "keyframe_full_step",
                     self._spanned("mapping", fused.keyframe_full_step))
        self._rebind(LocalMapper, "after_keyframe",
                     self._spanned("mapping", LocalMapper.after_keyframe))
        self._rebind(fused, "local_ba_step", self._spanned("local_ba", fused.local_ba_step))
        self._rebind(loop_closing, "_verify_candidate",
                     self._spanned("loop_closing", loop_closing._verify_candidate))
        rec = self
        k1_launch, k2_launch = cuda_hamming.launch, cuda_pose_opt.launch

        def k1(a, b, out):
            if rec.label is not None:
                rec.k1.append((rec.label, int(a.shape[0]), int(b.shape[0])))
            return k1_launch(a, b, out)

        def k2(Tcw0, obs, kp, rounds, iters, *outs):
            if rec.label is not None:
                # the real observations, summed on the device: no host read
                rec.k2.append((rec.label, int(obs.pw.shape[0]), obs.mask.sum(), rounds, iters))
            return k2_launch(Tcw0, obs, kp, rounds, iters, *outs)

        self._rebind(cuda_hamming, "launch", k1)
        self._rebind(cuda_pose_opt, "launch", k2)

    def uninstall(self) -> None:
        while self._restore:
            owner, attr, old = self._restore.pop()
            setattr(owner, attr, old)


class _FrameSpan:
    def __init__(self, rec: Recorder):
        self.rec = rec

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if self.rec.label is not None:
            self.rf = torch.profiler.record_function(PREFIX + "frame")
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rec.spans.append((self.rec.label, "frame", self.t0, time.perf_counter_ns()))
        return False


def _ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        return int(e.start_ns()), int(e.duration_ns())
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def summarize_profile(prof) -> dict:
    """From a stopped `torch.profiler.profile` (CPU and CUDA activities):
    `device` [(start_ns, end_ns)] of every device operation, `kernels`
    {name: [count, ns]}, `waits` [(start_ns, ns)] of the host's waiting
    CUDA calls, and `ranges` {span name: [(start_ns, end_ns)]} of the
    benchmark's record_function ranges, on the profiler's clock."""
    device, waits = [], []
    kernels: dict = defaultdict(lambda: [0, 0])
    ranges: dict = defaultdict(list)
    wait_names = {n for names in WAIT_CALLS.values() for n in names}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = _ns(e)
        if str(e.device_type()).endswith("CUDA"):
            if name.startswith(PREFIX):
                continue  # a range's projection onto the device timeline
            device.append((start, start + dur))
            k = kernels[name]
            k[0] += 1
            k[1] += dur
        elif name.startswith(PREFIX):
            ranges[name[len(PREFIX):]].append((start, start + dur))
        elif name in wait_names:
            waits.append((start, dur))
    return {"device": sorted(device), "kernels": dict(kernels), "waits": sorted(waits),
            "ranges": {k: sorted(v) for k, v in ranges.items()}}


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of sorted (start, end) intervals within [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: int, hi: int) -> list:
    """The gaps [(start, end)] between the device's busy intervals in [lo, hi]."""
    gaps, cur = [], lo
    for s, e in intervals:
        if e <= cur:
            continue
        s = max(s, lo)
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [g for g in gaps if g[1] > g[0]]
