"""Why `torch.profiler` at times records no CUDA kernel event around one K2
launch (`tests/test_torch_cuda.py::test_pose_kernel_wrapper_reads_nothing_on_host`).

    python3 tools/profiler_events_trace.py [SESSIONS]

On the card only. Each run below is one child process with Kineto's log
at its most verbose; the child makes one K2 launch with no profiler
running (it builds and loads the library), then SESSIONS (default 300)
profiled sessions of the test's call in each of its windows, in turns:
CUDA sync debug mode on, one K2 launch, a synchronisation. The windows:

- `tight`: the call alone, as the test profiled it in its own process;
- `margins_50ms`: 50 ms of host sleep inside the window before the call
  and after the synchronisation, as `_profiled_pose_launch` runs it.

The runs: each window alone in a fresh child (the test's case), then
both windows in turns in one child that lives through 2 x SESSIONS
sessions (a long-lived process, as the card-only file was). One JSON line
per run: the child's sessions whose Kineto record counts read
`Out-of-range` above 0 (GPU records whose timestamps, converted to the
host's clock, fall outside the capture window; Kineto drops them), and
for each window the sessions whose events hold no K2 kernel, those of
the last third, and over the sessions that hold the kernel the least and
the median distance in microseconds from the first host event of the
window to the kernel's start (negative where the converted start lies
before it) and from the kernel's end to the last.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WINDOWS = {"tight": 0.0, "margins_50ms": 0.05}


def _ns(e, name: str) -> int:
    """A kineto event's time in ns, across the PyTorch versions' names."""
    f = getattr(e, f"{name}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{name}_us")()) * 1000


def session(T0, obs, K, margin_s: float) -> dict:
    """The test's profiled call with `margin_s` of host sleep inside the
    window at each end; the K2 kernel events found and their margins."""
    from orbslam2_tpu_torch.solvers import cuda_pose_opt

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        torch.cuda.set_sync_debug_mode("error")
        try:
            cuda_pose_opt.pose_optimize_fast(T0, obs, K, 4, 6)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        time.sleep(margin_s)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    raw = list(prof.profiler.kineto_results.events())
    dev = [e for e in raw if e.device_type() == torch.autograd.DeviceType.CUDA]
    host = [e for e in raw if e.device_type() != torch.autograd.DeviceType.CUDA]
    out = {"kernels": sum("pose_gn" in n for n in names)}
    if dev and host:
        first = min(_ns(e, "start") for e in host)
        last = max(_ns(e, "start") + _ns(e, "duration") for e in host)
        out["lead_us"] = (min(_ns(e, "start") for e in dev) - first) / 1e3
        out["tail_us"] = (last - max(_ns(e, "start") + _ns(e, "duration") for e in dev)) / 1e3
    return out


def child(n: int, windows: list[str]) -> None:
    """One launch with no profiler, then `n` sessions of each window in
    turns, one JSON line each."""
    from chip_smoke import make_pose_problem
    from orbslam2_tpu_torch import config
    from orbslam2_tpu_torch.geometry.camera import Intrinsics
    from orbslam2_tpu_torch.solvers import cuda_pose_opt

    dev = torch.device("cuda")
    K = Intrinsics.from_config(config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5,
                                                   bf=48.0), dev)
    obs = make_pose_problem(np.random.default_rng(5), dev, n=1024, n_real=700, stereo_frac=0.6)
    T0 = torch.eye(4, device=dev)
    cuda_pose_opt.pose_optimize_fast(T0, obs, K, 4, 6)
    torch.cuda.synchronize()
    for _ in range(n):
        for w in windows:
            print(json.dumps(dict(session(T0, obs, K, WINDOWS[w]), window=w)), flush=True)


def trace(n: int, windows: list[str]) -> dict:
    env = dict(os.environ, KINETO_LOG_LEVEL="0")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", str(n),
                          ",".join(windows)], capture_output=True, text=True, timeout=1800,
                         env=env)
    recs = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    counts = [int(m.group(1)) for m in re.finditer(r"Out-of-range = (\d+)", out.stderr)]
    line = {"run": "+".join(windows), "sessions_with_out_of_range": sum(c > 0 for c in counts)}
    for w in windows:
        rs = [r for r in recs if r["window"] == w]
        lead = [r["lead_us"] for r in rs if "lead_us" in r]
        tail = [r["tail_us"] for r in rs if "tail_us" in r]
        line[w] = {"sessions": len(rs), "missed": sum(r["kernels"] == 0 for r in rs),
                   "missed_last_third": sum(r["kernels"] == 0 for r in rs[2 * len(rs) // 3:]),
                   "lead_us_min": min(lead) if lead else None,
                   "lead_us_median": float(np.median(lead)) if lead else None,
                   "tail_us_min": min(tail) if tail else None,
                   "tail_us_median": float(np.median(tail)) if tail else None}
    line["seconds"] = round(time.perf_counter() - t0, 2)
    if not recs:
        line["stderr_tail"] = out.stderr[-1500:]
    return line


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--child"]:
        child(int(sys.argv[2]), sys.argv[3].split(","))
        return
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    from orbslam2_tpu_torch import kernels

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    kernels.build()
    for windows in ([w] for w in WINDOWS):
        print(json.dumps(trace(n, windows)), flush=True)
    print(json.dumps(trace(n, list(WINDOWS))), flush=True)


if __name__ == "__main__":
    main()
