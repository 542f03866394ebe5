"""One benchmark run of one cell:

    python -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds `BENCHMARK.json`. The process
loads the cell's configuration and traffic mix, renders the session's
frames on the card (`slambench/render.py`), builds the session
(`orbslam2_tpu_torch.pipeline.system.System`), hands it the mix's
`setup` frames (set-up: a map of the session's start, which meets every
shape and the loop closer's first verification), then goes on handing
over frames closed loop (the next frame when the previous call has
returned its pose) for `--seconds`, as the mix's `window` passes order
them (a "fresh" pass starts with ORB-SLAM2's Reset, counted in the
window).

With `--trace 0` the result line carries the cell's end-to-end metrics:
`fps` (frames whose pose came back in the window over the window's
seconds), `frame_p95_ms` (the 95th percentile of each window frame's
hand-off to pose), `ate_mm` (RMS trajectory error of the window's
sessions from their first frame, each aligned on its own) and `setup_s`
(from the process's start to the window's, less the time spent making
the frames). With `--trace 1` the window is half of `--seconds` with the
layer spans on (the host-time readers), then the mix's `profiled_frames`
under `torch.profiler` with 50 ms margins (the device readers); the line
carries the per-layer metrics that the readers in `slambench/metrics/`
find, and `device.busy_s` / `window_s`.

In every run, once the window has closed and the session is freed, the
plain reference (`slambench/reference.py`) judges what the timed path
produced against the limits in `slambench/limits/<cell>.json`; each
number is printed beside its limit on standard error and under `checks`,
the last key of the result line. Exits non-zero with no result line
without a CUDA device, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from slambench import cell as cellmod  # noqa: E402
from slambench import reference, render, tracing  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam2_tpu")
PROFILE_MARGIN_S = 0.05
PINNED_CORES = 2


def set_process_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and one thread for the host's numerical libraries: one process with
    few threads keeps the host's share of the card steady."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def pin_process() -> None:
    """Pin the process (and the threads it starts) to fixed cores, the
    first `PINNED_CORES` of those it may use, so that runs of a cell do
    not move between cores."""
    if hasattr(os, "sched_setaffinity"):
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, allowed[:PINNED_CORES])


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

class Frames:
    """The session's frames as the program is handed them (host arrays:
    8-bit images, and RGB-D depth decoded to metres at hand-off), the
    ground truth beside them, and for stereo the true depth."""

    def __init__(self, c: cellmod.Cell, device):
        mix = c.mix
        self.gt = render.trajectory(mix, c.fps)
        self.world = render.make_room(seed=int(mix["room"]))
        self.stored = render.session_frames(self.world, self.gt, c.camera, c.stereo,
                                            float(mix.get("noise", 1.0)), int(mix["room"]),
                                            device)
        self.stereo = c.stereo

    def inputs(self, i: int):
        a = self.stored["left"][i]
        if self.stereo:
            return a, self.stored["right"][i]
        return a, render.decode_depth(self.stored["depth"][i])

    def truth_depth(self, i: int) -> np.ndarray:
        return render.decode_depth(self.stored["depth"][i], render.TRUTH_UNITS)


# ---------------------------------------------------------------------------
# the session driver
# ---------------------------------------------------------------------------

class Driver:
    """Hands one cell's frames to one session, as the mix orders them,
    and keeps what the reference judges: every window frame's pose and
    time, the sampled frames' build outputs, and each session's
    trajectory and map at its close.

    The mix's `setup` segments are handed over before the window; its
    `window` is a list of passes, the last repeated until the window
    ends, each with `segments` and a `map`: "continue" (the session goes
    on) or "fresh" (ORB-SLAM2's Reset first, counted in the window)."""

    def __init__(self, c: cellmod.Cell, frames: Frames, slam, seed: int, rec: tracing.Recorder):
        self.c, self.frames, self.slam, self.seed, self.rec = c, frames, slam, seed, rec
        self.track = slam.track_stereo if c.stereo else slam.track_rgbd
        self.k = 0                   # frames handed over, for timestamps
        self.n_window = 0            # window frames handed over
        self.records: list = []      # per window frame: (session, index, ms, pose)
        self.sampled: list = []      # (index, FrameData)
        self.sessions: list = []     # per closed session: its trajectory and map
        self._session = None         # the open session: {"order", "window", "n_results", "base"}
        k = int(c.mix.get("sampled_frames", 16))
        span = int(c.mix.get("sample_span", 300))
        rng = np.random.default_rng([seed, 7])
        self.sample = set(rng.choice(span, size=min(k, span), replace=False).tolist())

    def _hand(self, i: int, window: bool):
        a, b = self.frames.inputs(i)
        if self._session is None:
            self._session = {"order": [], "window_from": None,
                             "n_results": len(self.slam.results), "base": None}
        with self.rec.frame():
            t0 = time.perf_counter()
            pose = self.track(a, b, self.k / self.c.fps)
            ms = 1e3 * (time.perf_counter() - t0)
        self.k += 1
        s = self._session
        lf = self.slam.tracker.last_frame
        if s["base"] is None:
            s["base"] = int(lf.frame_id) if lf is not None else 0
        s["order"].append(i)
        if window:
            if s["window_from"] is None:
                s["window_from"] = len(s["order"]) - 1
            self.records.append((len(self.sessions), i, ms, np.asarray(pose, np.float64)))
            if self.n_window in self.sample and lf is not None:
                self.sampled.append((i, lf))
            self.n_window += 1

    def close_session(self) -> None:
        """Keep the open session's trajectory (the program's `frame_poses`,
        re-anchored to the final keyframes), its frames' states and its
        map's keyframes, each by the frame it was made from."""
        s, self._session = self._session, None
        if s is None:
            return
        slam, n = self.slam, len(s["order"])
        _, poses, tracked = slam.frame_poses()
        m = slam.map
        kf_valid = m.kf_valid.cpu().numpy()
        kf_pos = np.clip(m.kf_frame_id.cpu().numpy()[kf_valid] - s["base"], 0, n - 1)
        states = [r.state.name for r in slam.results[s["n_results"]:]]
        keyframe = [bool(r.is_keyframe) for r in slam.results[s["n_results"]:]]
        w = s["window_from"]
        self.sessions.append({
            "window": w is not None, "order": s["order"],
            "traj": poses[len(poses) - n:], "tracked": tracked[len(tracked) - n:],
            "window_states": states[w:] if w is not None else [],
            "window_keyframes": sum(keyframe[w:]) if w is not None else 0,
            "kf_Tcw": m.kf_Tcw.cpu().numpy()[kf_valid],
            "kf_index": np.asarray(s["order"])[kf_pos]})

    def reset(self) -> None:
        self.close_session()
        self.slam.reset()

    def setup(self) -> None:
        for i in cellmod.frame_order(self.c.mix["setup"]):
            self._hand(i, window=False)

    def stream(self):
        """The window's frame indices, resetting where a pass asks."""
        passes = self.c.mix["window"]
        p = 0
        while True:
            spec = passes[min(p, len(passes) - 1)]
            if spec.get("map", "continue") == "fresh":
                self.reset()
            yield from cellmod.frame_order(spec["segments"])
            p += 1

    def run(self, stream, deadline=None, frames=None) -> int:
        """Hand over window frames until `deadline` (perf_counter) has
        passed or `frames` have been handed over; returns how many."""
        n = 0
        for i in stream:
            self._hand(i, window=True)
            n += 1
            if deadline is not None and time.perf_counter() >= deadline:
                break
            if frames is not None and n >= frames:
                break
        return n


# ---------------------------------------------------------------------------
# the reference's judgement
# ---------------------------------------------------------------------------

def judge(c: cellmod.Cell, frames: Frames, drv: Driver, sampled_host: list,
          control: str | None = None) -> dict:
    """The numbers the plain reference compares, by name. With `control`
    "bf16" the reference itself, computed in bfloat16, takes the
    program's place in the frame build: its FAST decision at the
    program's keypoints, its descriptors there, and for RGB-D its read of
    the depth map rounded to bfloat16, are what the numbers judge."""
    orb_scale = float(c.settings["ORBextractor.scaleFactor"])
    levels = int(c.settings["ORBextractor.nLevels"])
    th_lo = float(c.settings["ORBextractor.minThFAST"])
    bits = total = missed = 0
    depth_gap, bad, with_depth = 0.0, 0, 0
    bf = float(c.settings["Camera.bf"])
    for i, f in sampled_host:
        a, b = frames.inputs(i)
        v = f["valid"]
        xy, octave = f["xy_raw"][v], f["octave"][v]
        _, desc = reference.descriptors(a, xy, octave, orb_scale, levels)
        got = f["desc"][v].view(np.uint32)
        found = reference.keypoint_found(a, xy, octave, orb_scale, levels, th_lo)
        if control == "bf16":
            _, got = reference.descriptors(a, xy, octave, orb_scale, levels, rnd=reference.bf16)
            marked = reference.keypoint_found(a, xy, octave, orb_scale, levels, th_lo,
                                              rnd=reference.bf16)
            missed += int((marked != found).sum())
        else:
            missed += int((~found).sum())
        bits += int(reference.popcount(got ^ desc).sum())
        total += 256 * int(v.sum())
        if c.stereo:
            truth = frames.truth_depth(i)
            d = f["depth"][v]
            H, W = truth.shape
            ix = np.clip(np.rint(xy[:, 0]).astype(np.int64), 0, W - 1)
            iy = np.clip(np.rint(xy[:, 1]).astype(np.int64), 0, H - 1)
            z = truth[iy, ix]
            sel = (d > 0) & (z > 0)
            with_depth += int(sel.sum())
            bad += int((np.abs(bf / d[sel] - bf / z[sel]) > 1.0).sum())
        else:
            ref = reference.rgbd_depth(f["xy_raw"], v, b)
            got = f["depth"]
            if control == "bf16":
                got = reference.rgbd_depth(f["xy_raw"], v, reference.bf16(b))
            depth_gap = max(depth_gap, float(np.abs(got - ref).max()))
    out = {"kp_miss_pct": 100.0 * missed / max(total // 256, 1),
           "desc_bits_pct": 100.0 * bits / max(total, 1)}
    if c.stereo:
        out["stereo_bad_pct"] = 100.0 * bad / max(with_depth, 1)
    else:
        out["depth_gap_m"] = depth_gap
    gt = frames.gt
    idx = np.asarray([r[1] for r in drv.records])
    est = np.stack([r[3] for r in drv.records])
    finite = np.isfinite(est).all(axis=(1, 2))
    est_ok = np.where(finite[:, None, None], est, np.eye(4))
    out["pose_gap_mm"] = 1e3 * float(np.linalg.norm(
        reference.centers(est_ok) - reference.centers(gt[idx]), axis=1).max())
    out["rot_gap_deg"] = float(reference.rotation_deg(est_ok, gt[idx]).max())
    kf_gap = 0.0
    for s in drv.sessions:
        if len(s["kf_Tcw"]):
            kf_gap = max(kf_gap, 1e3 * float(np.linalg.norm(
                reference.centers(s["kf_Tcw"].astype(np.float64))
                - reference.centers(gt[s["kf_index"]]), axis=1).max()))
    out["kf_gap_mm"] = kf_gap
    out["lost"] = float(sum(st != "OK" for s in drv.sessions for st in s["window_states"])
                        + int((~finite).sum()))
    return out


def end_to_end(frame_ms, window_s: float, sessions: list, gt: np.ndarray, setup_s: float) -> dict:
    """The end-to-end metrics of a window: `fps` over every frame whose
    pose came back in it, `frame_p95_ms` over every frame's hand-off to
    pose, `ate_mm` and `setup_s`. `ate_mm` is the RMS camera-centre error
    of every tracked frame of the sessions the window ran (a session that
    the window continues counts from its first frame in set-up), each
    session aligned on its own (rigid Umeyama), as TUM's evaluate_ate
    scores a run's trajectory."""
    frame_ms = np.asarray(frame_ms, np.float64)
    errs = []
    for s in sessions:
        ok = np.asarray(s["tracked"], bool)
        if s["window"] and ok.sum() >= 3:
            errs.append(reference.aligned_errors(s["traj"][ok], gt[np.asarray(s["order"])[ok]]))
    ate_m = float(np.sqrt(np.mean(np.concatenate(errs) ** 2))) if errs else float("nan")
    return {"fps": {"value": len(frame_ms) / window_s, "unit": "frames/s"},
            "frame_p95_ms": {"value": float(np.percentile(frame_ms, 95)), "unit": "ms"},
            "ate_mm": {"value": 1e3 * ate_m, "unit": "mm"},
            "setup_s": {"value": setup_s, "unit": "s"}}


# ---------------------------------------------------------------------------
# per-layer metrics
# ---------------------------------------------------------------------------

class TraceData:
    """What a per-layer reader reads: the spans pass's spans, frames and
    keyframes, and the profiled pass's summary, window and launches."""

    def __init__(self, rec: tracing.Recorder, frames: int, keyframes: int, device_type: str):
        self.device_type = device_type
        self.frames, self.keyframes = frames, keyframes
        self.span_ns: dict = {}
        self.span_count: dict = {}
        for label, name, t0, t1 in rec.spans:
            if label == "spans":
                self.span_ns[name] = self.span_ns.get(name, 0) + (t1 - t0)
                self.span_count[name] = self.span_count.get(name, 0) + 1
        self.profile = rec.profile
        self.window = None
        if self.profile is not None and self.profile["ranges"].get("frame"):
            fr = self.profile["ranges"]["frame"]
            self.window = (fr[0][0], max(e for _, e in fr))
        self.k1 = [(n, m) for label, n, m in rec.k1 if label == "profiled"]
        self.k2 = [(n, int(e), r, i) for label, n, e, r, i in rec.k2 if label == "profiled"]

    def kernel(self, key: str):
        """(launches traced, device ns) of kernel K1 or K2 by its name."""
        if self.profile is None:
            return 0, 0
        name = tracing.KERNEL_NAMES[key]
        hits = [v for k, v in self.profile["kernels"].items() if name in k]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def busy_ns(self) -> int:
        return tracing.union_ns(self.profile["device"], *self.window)


def read_metrics(root: Path, bench: dict, workload: str, data: TraceData) -> dict:
    """Each per-layer metric of this cell that its reader finds."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        path = root / "slambench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"slambench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(data)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(data: TraceData, rec: tracing.Recorder) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled by the innermost benchmark span the host was in."""
    prof = data.profile
    ops = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(tracing.idle_gaps(prof["device"], *data.window), key=lambda g: g[0] - g[1])[:10]
    spans = [(s, e, n) for n, rs in prof["ranges"].items() for s, e in rs]

    def label(mid):
        inner = [(e - s, n) for s, e, n in spans if s <= mid < e]
        return min(inner)[1] if inner else "between frames"

    return {"device_ops": [[n[:120], v[1] / 1e9] for n, v in ops],
            "idle_gaps": [[label((s + e) // 2), (e - s) / 1e9] for s, e in gaps]}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: str | None = None,
             t_process: float = T_PROCESS, frames_cache: dict | None = None) -> dict:
    """One run; returns {"result": the result line's object, "numbers":
    the compared numbers, "log": lines for standard error}. With `control`
    "bf16" the reference in bfloat16 takes the program's place in the
    frame build (see `judge`): the checks then compare the control's
    numbers, and "sound" holds the program's own. `frames_cache` (a dict)
    keeps the rendered frames for further runs of the cell in the same
    process."""
    import torch

    bench = cellmod.load_benchmark(root)
    c = cellmod.load_cell(root, workload)
    seed = seed % 2**64
    dev = torch.device(device)
    t_in = time.perf_counter()
    if frames_cache is not None and workload in frames_cache:
        frames = frames_cache[workload]
    else:
        frames = Frames(c, dev)
    if frames_cache is not None:
        frames_cache[workload] = frames
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    inputs_s = time.perf_counter() - t_in

    from orbslam2_tpu_torch import kernels
    from orbslam2_tpu_torch.pipeline import loop_closing
    from orbslam2_tpu_torch.pipeline.system import System

    if dev.type == "cuda":
        kernels.library()
    verifications = [0]
    verify = loop_closing._verify_candidate

    def counted(*a, **k):
        verifications[0] += 1
        return verify(*a, **k)

    loop_closing._verify_candidate = counted
    slam = System(c.slam_config(), device=dev,
                  enable_loop_closing=bool(c.mix.get("loop_closing", True)))
    rec = tracing.Recorder()
    drv = Driver(c, frames, slam, seed, rec)
    drv.setup()
    if c.mix.get("localization", False):
        slam.activate_localization_mode()
    stream = drv.stream()
    setup_verifications = verifications[0]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process - inputs_s

    t0 = time.perf_counter()
    prof = None
    if not trace:
        drv.run(stream, deadline=t0 + seconds)
        window_s = time.perf_counter() - t0
    else:
        rec.install()
        rec.label = "spans"
        drv.run(stream, deadline=t0 + seconds / 2)
        span_frames = len(drv.records)
        span_kf = sum(1 for s in drv.slam.results[-span_frames:] if s.is_keyframe)
        rec.label = "profiled"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        time.sleep(PROFILE_MARGIN_S)
        drv.run(stream, frames=int(c.mix.get("profiled_frames", 120)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        prof.stop()
        rec.label = None
        rec.uninstall()
        window_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    gc.unfreeze()
    # the window has closed: the device's peak, then the session's outputs
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_frames = len(drv.records)
    drv.close_session()
    loop_closing._verify_candidate = verify
    sampled_host = [(i, {k: getattr(f, k).cpu().numpy()
                         for k in ("xy_raw", "octave", "desc", "valid", "depth")})
                    for i, f in drv.sampled]
    window_verifications = verifications[0] - setup_verifications
    kf_frames = sum(s["window_keyframes"] for s in drv.sessions)
    n_kf = max((len(s["kf_Tcw"]) for s in drv.sessions), default=0)
    loops = int(getattr(slam.loop_closer, "loops_closed", 0) or 0)
    data = None
    if trace:
        rec.profile = tracing.summarize_profile(prof)
        del prof
        data = TraceData(rec, span_frames, span_kf, dev.type)
    del slam, drv.slam, drv.track
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = judge(c, frames, drv, sampled_host)
    sound = None
    if control == "bf16":
        sound, numbers = numbers, judge(c, frames, drv, sampled_host, control="bf16")
    failed = int(numbers["lost"])
    log = [f"cell {workload} seed {seed} trace {int(trace)} device "
           f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
           + (f" control {control}" if control else ""),
           f"inputs_s {inputs_s:.3f} setup_s {setup_s:.3f} window_s {window_s:.3f} "
           f"frames {window_frames} sessions {len(drv.sessions)} keyframe_frames {kf_frames} "
           f"keyframes_in_map {n_kf} sampled {len(sampled_host)} "
           f"verifications setup {setup_verifications} window {window_verifications} "
           f"loops_closed {loops}"]
    ms = np.asarray([r[2] for r in drv.records])
    if not trace:
        metrics = end_to_end(ms, window_s, drv.sessions, frames.gt, setup_s)
        log.append(f"frame_p50_ms {float(np.median(ms)):.3f} frame_max_ms {float(ms.max()):.3f}")
    else:
        metrics = read_metrics(root, bench, workload, data)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": None, "attempted": window_frames, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and data is not None and data.window is not None:
        device_info["busy_s"] = data.busy_ns() / 1e9
        device_info["window_s"] = (data.window[1] - data.window[0]) / 1e9
        result["breakdown"] = breakdown(data, rec)
        log.append(f"k1 launches {len(data.k1)} traced {data.kernel('k1')[0]}; "
                   f"k2 launches {len(data.k2)} traced {data.kernel('k2')[0]}")
    # every number the cell's limits file names is compared; a cell
    # without limits is never correct
    checks, correct = {}, bool(c.limits)
    for name, limit in c.limits.items():
        value = numbers.get(name, float("nan"))
        correct = correct and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    result["correct"] = bool(correct)
    result["checks"] = checks
    log += [f"reading {n} {v!r}" for n, v in numbers.items() if n not in checks]
    log += [f"check {n} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if math.isfinite(v['value']) and v['value'] <= v['limit'] else 'FAIL'}"
            for n, v in checks.items()]
    return {"result": result, "numbers": numbers, "sound": sound, "log": log}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one slambench run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    try:
        bench = cellmod.load_benchmark(root)
        chips = {w["name"]: int(w.get("chips", 1)) for w in bench["workloads"]}[args.workload]
    except (FileNotFoundError, KeyError) as e:
        print(f"slambench: {e!r}", file=sys.stderr)
        return 2
    set_process_env()
    pin_process()
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    out = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {bad}", file=sys.stderr)
        return 4
    for line in out["log"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
