"""The program's own spans and counters (`orbslam2_tpu_torch.profiling`)
beside the benchmark's trace, and a traced run that records them:

    python -m slambench.program_trace --workload <cell> --seed <n> --seconds <s> \
        [--cost-frames <n>] [--out <file.json>]

The traced run is `run.run_cell` with `--trace 1` and the program's
tracer on from before set-up; the program's records are taken at the end
of set-up, of the span pass and of the profiled pass, and the profiled
pass's summary also keeps the start of every CUDA launch call the host
made. It prints, on standard error, one line per program span name and
pass (count, host ms in total, per call, first and largest call, self
ms, K1 / K2 launches; in the profiled pass also the CUDA launch calls,
the host's waiting CUDA calls and the device-busy ms inside the span),
the counters per pass, the clock check (each program span against its
`orbslam2.*` profiler range), the per-layer metrics the readers of this
module find (`slambench/metrics/{frame_build.launches, tracking.launches,
mapping.keyframe_launches, loop_closing.verify_launches,
session.read_wait_ms}.py`) and the longest idle gaps labelled
`<benchmark span>/<program span>`. With `--cost-frames` it then maps the
cell's set-up frames in a fresh session and hands over that many window
frames with the tracer on and off in turn (the benchmark's rebinding not
installed), and prints the frame times of each side.

Launch calls are attributed to the innermost program span whose interval,
from the program's span list, holds the call's start: both are stamped
on the profiler's host clock.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

from slambench import tracing

# the host's CUDA calls that launch a kernel, as the trace names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
PROGRAM_PREFIX = "orbslam2."
# the program's spans in which the host waits for the card by design
READ_SUFFIX = "_read"
PASSES = ("setup", "spans", "profiled")


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def innermost(spans, times) -> list[int]:
    """For each of the sorted `times`, the index of the innermost span (a
    list of properly nested records with `start_ns` / `end_ns`, in the
    order they opened) whose [start, end) holds it, or -1."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j].start_ns <= t:
            while stack and spans[stack[-1]].end_ns <= spans[j].start_ns:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]].end_ns <= t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def inclusive(spans, own) -> list:
    """Per span, `own` summed over the span and everything inside it (a
    child's index is larger than its parent's)."""
    total = list(own)
    for i in range(len(spans) - 1, -1, -1):
        p = spans[i].parent
        if p >= 0:
            total[p] += total[i]
    return total


def attribute(spans, times, weights=None) -> list:
    """Per span, the count (or the summed `weights`) of the sorted `times`
    inside it, the spans inside it included."""
    own = [0] * len(spans)
    for k, i in enumerate(innermost(spans, times)):
        if i >= 0:
            own[i] += 1 if weights is None else weights[k]
    return inclusive(spans, own)


class Busy:
    """The union of sorted device intervals, for the busy ns inside any
    host interval in O(log n)."""

    def __init__(self, intervals):
        self.starts, self.ends, self.before = [], [], [0]
        for s, e in intervals:
            if self.ends and s <= self.ends[-1]:
                if e > self.ends[-1]:
                    self.before[-1] += e - self.ends[-1]
                    self.ends[-1] = e
                continue
            self.starts.append(s)
            self.ends.append(e)
            self.before.append(self.before[-1] + e - s)

    def within(self, lo: int, hi: int) -> int:
        i = bisect.bisect_right(self.ends, lo)
        j = bisect.bisect_left(self.starts, hi)
        if j <= i:
            return 0
        total = self.before[j] - self.before[i]
        total -= max(0, lo - self.starts[i])
        total -= max(0, self.ends[j - 1] - hi)
        return total


# ---------------------------------------------------------------------------
# what the per-layer readers read
# ---------------------------------------------------------------------------

def records(t, pass_name: str):
    """The program's records of one pass of a traced run ({"spans",
    "counters"}), or None where the run kept none."""
    program = getattr(t, "program", None)
    return program.get(pass_name) if program else None


def launches_per(t, names, per: str):
    """CUDA launch calls of the profiled pass inside the program's spans
    named `names`, over the number of spans named `per` there; None where
    the trace holds no launch calls or no such span."""
    rec = records(t, "profiled")
    launches = t.profile.get("launches") if t.profile else None
    if rec is None or not launches:
        return None
    spans = rec["spans"]
    n = sum(1 for s in spans if s.name == per)
    if not n:
        return None
    inside = attribute(spans, launches)
    return sum(c for s, c in zip(spans, inside) if s.name in names) / n


def read_wait_ms(t):
    """Host ms per frame of the span pass inside the program's read spans
    (the outermost `*_read` span of each nest)."""
    rec = records(t, "spans")
    if rec is None or not t.frames:
        return None
    spans = rec["spans"]
    ns = 0
    for s in spans:
        if s.name.endswith(READ_SUFFIX):
            p = s.parent
            while p >= 0 and not spans[p].name.endswith(READ_SUFFIX):
                p = spans[p].parent
            if p < 0:
                ns += s.end_ns - s.start_ns
    return ns / 1e6 / t.frames


# ---------------------------------------------------------------------------
# the traced run's summaries
# ---------------------------------------------------------------------------

def summarize_profile(prof, base=tracing.summarize_profile) -> dict:
    """`base` (the benchmark's `tracing.summarize_profile`), less the
    device projections of the program's `orbslam2.*` ranges (annotations,
    not device work), plus `launches` (the sorted starts of the host's
    CUDA launch calls) and `program_ranges` [(name, start_ns, end_ns)]
    (the program's ranges on the host)."""
    out = base(prof)
    drop, launches, ranges = set(), [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = tracing._ns(e)
        on_device = str(e.device_type()).endswith("CUDA")
        if name.startswith(PROGRAM_PREFIX):
            if on_device:
                drop.add((start, start + dur))
                out["kernels"].pop(name, None)
            else:
                ranges.append((name[len(PROGRAM_PREFIX):], start, start + dur))
        elif name in LAUNCH_CALLS and not on_device:
            launches.append(start)
    if drop:
        out["device"] = [iv for iv in out["device"] if iv not in drop]
    out["launches"] = sorted(launches)
    out["program_ranges"] = sorted(ranges, key=lambda r: r[1])
    return out


def stage_table(spans, profile=None) -> dict:
    """Per span name: count, host ms (total, first call, largest call),
    self ms (the span less the spans inside it), K1 / K2 launches, and
    with a profile the CUDA launch calls, the waiting CUDA calls' ms and
    the device-busy ms inside the spans."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    launches = waits = busy = None
    if profile is not None:
        launches = attribute(spans, profile.get("launches", []))
        w = profile["waits"]
        waits = attribute(spans, [s for s, _ in w], [d for _, d in w])
        busy = Busy(profile["device"])
    table: dict = {}
    for i, s in enumerate(spans):
        ns = s.end_ns - s.start_ns
        row = table.setdefault(s.name, {"n": 0, "ms": 0.0, "first_ms": ns / 1e6, "max_ms": 0.0,
                                        "self_ms": 0.0, "k1": 0, "k2": 0})
        row["n"] += 1
        row["ms"] += ns / 1e6
        row["max_ms"] = max(row["max_ms"], ns / 1e6)
        row["self_ms"] += (ns - child_ns[i]) / 1e6
        row["k1"] += s.k1
        row["k2"] += s.k2
        if profile is not None:
            row["launches"] = row.get("launches", 0) + launches[i]
            row["wait_ms"] = row.get("wait_ms", 0.0) + waits[i] / 1e6
            row["busy_ms"] = row.get("busy_ms", 0.0) + busy.within(s.start_ns, s.end_ns) / 1e6
    return table


def stage_lines(pass_name: str, table: dict) -> list[str]:
    lines = []
    for name, r in sorted(table.items(), key=lambda kv: -kv[1]["ms"]):
        line = (f"program {pass_name} {name} n {r['n']} ms {r['ms']:.3f} "
                f"per_call_ms {r['ms'] / r['n']:.3f} first_ms {r['first_ms']:.3f} "
                f"max_ms {r['max_ms']:.3f} self_ms {r['self_ms']:.3f} k1 {r['k1']} k2 {r['k2']}")
        if "launches" in r:
            line += (f" launches {r['launches']} wait_ms {r['wait_ms']:.3f} "
                     f"busy_ms {r['busy_ms']:.3f}")
        lines.append(line)
    return lines


def clock_check(spans, program_ranges, skip: int = 10):
    """The largest gap (ns) between a program span's ends and its
    profiler range's, pairing them by name in order, past the first
    `skip` spans; None without ranges."""
    by_name: dict = {}
    for name, s, e in program_ranges:
        by_name.setdefault(name, []).append((s, e))
    seen: dict = {}
    worst = None
    for k, sp in enumerate(spans):
        j = seen.get(sp.name, 0)
        seen[sp.name] = j + 1
        got = by_name.get(sp.name, [])
        if k < skip or j >= len(got):
            continue
        s, e = got[j]
        gap = max(abs(s - sp.start_ns), abs(e - sp.end_ns))
        worst = gap if worst is None else max(worst, gap)
    return worst


def labelled_gaps(data, top: int = 10) -> list:
    """The longest idle gaps of the profiled pass, each labelled by the
    innermost benchmark span the host was in at the gap's middle and,
    inside a program span, `<benchmark span>/<program span>`."""
    prof = data.profile
    gaps = sorted(tracing.idle_gaps(prof["device"], *data.window),
                  key=lambda g: g[0] - g[1])[:top]
    bench = sorted(((s, e, n) for n, rs in prof["ranges"].items() for s, e in rs))
    rec = records(data, "profiled")
    spans = rec["spans"] if rec else []
    mids = sorted((s + e) // 2 for s, e in gaps)
    inner = dict(zip(mids, innermost(spans, mids)))
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        hits = [(b - a, n) for a, b, n in bench if a <= mid < b]
        label = min(hits)[1] if hits else "between frames"
        if inner[mid] >= 0:
            label += "/" + spans[inner[mid]].name
        out.append([label, (e - s) / 1e9])
    return out


# ---------------------------------------------------------------------------
# the traced run
# ---------------------------------------------------------------------------

# the per-layer metrics whose readers read the program's records, by unit
NEW_METRICS = {"frame_build.launches": "launches/frame", "tracking.launches": "launches/frame",
               "mapping.keyframe_launches": "launches/keyframe",
               "loop_closing.verify_launches": "launches/verification",
               "session.read_wait_ms": "ms"}


def read_new_metrics(root: Path, workload: str, data) -> dict:
    """What the readers of `NEW_METRICS` find, as `run.read_metrics` gives it."""
    from slambench import run

    bench = {"per_layer": [{"name": n, "unit": u} for n, u in NEW_METRICS.items()]}
    return run.read_metrics(root, bench, workload, data)


def traced_run(root: Path, workload: str, seed: int, seconds: float, frames_cache: dict) -> dict:
    """`run.run_cell` with `--trace 1` and the program's tracer on, its
    records taken per pass; returns the run's output, the TraceData and
    the records."""
    from orbslam2_tpu_torch import profiling
    from slambench import run

    taken: dict = {}
    captured: list = []
    setup, drive, summarize, trace_data = (run.Driver.setup, run.Driver.run,
                                           tracing.summarize_profile, run.TraceData)

    def setup_then_take(self):
        setup(self)
        taken["setup"] = profiling.take()

    def drive_then_take(self, stream, deadline=None, frames=None):
        n = drive(self, stream, deadline=deadline, frames=frames)
        taken["spans" if deadline is not None else "profiled"] = profiling.take()
        return n

    class Data(trace_data):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.program = taken
            captured.append(self)

    run.Driver.setup, run.Driver.run, run.TraceData = setup_then_take, drive_then_take, Data
    tracing.summarize_profile = lambda prof: summarize_profile(prof, base=summarize)
    profiling.take()
    profiling.enable()
    try:
        out = run.run_cell(root, workload, seed, seconds, True, frames_cache=frames_cache)
    finally:
        profiling.disable()
        run.Driver.setup, run.Driver.run, run.TraceData = setup, drive, trace_data
        tracing.summarize_profile = summarize
    return {"out": out, "data": captured[0] if captured else None, "program": taken}


def cost_run(root: Path, workload: str, seed: int, n_frames: int, frames_cache: dict) -> dict:
    """A fresh session of the cell: its set-up frames with the tracer off,
    then `n_frames` window frames in pairs, the tracer on for one frame of
    each pair and off for the other (on first, then off first, in turn, so
    that neither side is always the first). Returns each side's frame ms,
    the median gap within a pair over all pairs and over the pairs of two
    plain frames (each under twice the median frame: no keyframe and no
    verification), the spans a traced frame opened and a span's own cost."""
    import torch

    from orbslam2_tpu_torch import profiling
    from orbslam2_tpu_torch.pipeline.system import System
    from slambench import cell as cellmod
    from slambench import run

    c = cellmod.load_cell(root, workload)
    slam = System(c.slam_config(), device="cuda",
                  enable_loop_closing=bool(c.mix.get("loop_closing", True)))
    drv = run.Driver(c, frames_cache[workload], slam, seed, tracing.Recorder())
    drv.setup()
    stream = drv.stream()
    pairs, spans = [], 0
    for k in range(n_frames // 2):
        ms = {}
        for traced in ((True, False) if k % 2 == 0 else (False, True)):
            if traced:
                profiling.enable()
            drv.run(stream, frames=1)
            profiling.disable()
            ms[traced] = drv.records[-1][2]
            spans += len(profiling.take()["spans"])
        pairs.append((ms[True], ms[False]))
    torch.cuda.synchronize()
    per_span = {}
    for state in (True, False):
        (profiling.enable if state else profiling.disable)()
        t0 = time.perf_counter_ns()
        for _ in range(20000):
            with profiling.span("cost"):
                pass
        per_span["on" if state else "off"] = (time.perf_counter_ns() - t0) / 20000 / 1e3
    profiling.disable()
    profiling.take()
    on, off = [a for a, _ in pairs], [b for _, b in pairs]
    limit = 2 * statistics.median(on + off)
    plain = [a - b for a, b in pairs if a < limit and b < limit]
    return {"frames": 2 * len(pairs), "on_ms": on, "off_ms": off,
            "median_on_ms": statistics.median(on), "median_off_ms": statistics.median(off),
            "mean_on_ms": statistics.fmean(on), "mean_off_ms": statistics.fmean(off),
            "median_pair_gap_ms": statistics.median([a - b for a, b in pairs]),
            "plain_pairs": len(plain), "median_plain_pair_gap_ms": statistics.median(plain),
            "spans_per_traced_frame": spans / max(len(pairs), 1), "span_us": per_span}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a traced slambench run with the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost-frames", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from slambench import run

    run.set_process_env()
    run.pin_process()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("program_trace: no CUDA device", file=sys.stderr)
        return 3
    root = Path.cwd()
    cache: dict = {}
    got = traced_run(root, args.workload, args.seed, args.seconds, cache)
    out, data, taken = got["out"], got["data"], got["program"]
    log = list(out["log"])
    report = {"workload": args.workload, "seed": args.seed, "result": out["result"]}
    tables = {}
    for p in PASSES:
        rec = taken.get(p)
        if rec is None:
            continue
        profile = data.profile if (p == "profiled" and data is not None) else None
        tables[p] = stage_table(rec["spans"], profile)
        log += stage_lines(p, tables[p])
        log.append(f"program {p} counters {json.dumps(rec['counters'], sort_keys=True)}")
    report["stages"] = tables
    report["counters"] = {p: taken[p]["counters"] for p in taken}
    if data is not None and data.profile is not None:
        gap = clock_check(taken["profiled"]["spans"], data.profile["program_ranges"])
        report["clock_gap_us"] = None if gap is None else gap / 1e3
        report["new_metrics"] = read_new_metrics(root, args.workload, data)
        report["idle_gaps"] = labelled_gaps(data) if data.window is not None else []
        log.append(f"program clock: largest span/range gap {report['clock_gap_us']} us")
        log.append(f"program metrics {json.dumps(report['new_metrics'], sort_keys=True)}")
        log.append(f"program idle_gaps {json.dumps(report['idle_gaps'])}")
    if args.cost_frames:
        cost = cost_run(root, args.workload, args.seed, args.cost_frames, cache)
        report["cost"] = cost
        log.append("program cost " + json.dumps({k: v for k, v in cost.items()
                                                 if k not in ("on_ms", "off_ms")}))
    for line in log:
        print(line, file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report))
    print(json.dumps({"workload": args.workload, "metrics": out["result"]["metrics"],
                      "new_metrics": report.get("new_metrics"),
                      "correct": out["result"]["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
