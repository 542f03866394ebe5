"""The port's tracer (`orbslam2_tpu_torch.profiling`: `span`, `spanned`,
`count`, `enable`, `take`) on short CPU sessions, and the benchmark's
readers of its records (`slambench/program_trace.py` and the five
readers in `slambench/metrics/`) on a hand-built trace:

* off, a session's frames read no clock, open no profiler range and
  record nothing;
* on, every frame is one `frame` root with its id, the frame build and
  the track step under it (two extractions a stereo frame), a keyframe's
  step with its local BA, a verification's dispatch and read with the
  same keyframe and candidate ids and counters that add up; `take()`
  clears;
* under a CPU `torch.profiler` each span and its `orbslam2.*` range agree
  at both ends within 0.1 ms;
* with the tracer on, the benchmark's own rebinding (`Recorder.install`)
  still records every one of its spans;
* in localization mode, a frame on the odometry path is one
  `tracking.localization_vo` span holding the relocalization attempt and
  the odometry step (`tracking.vo`), and the `localization.*` counters
  count the frames.

The sessions are the mapping slice's 320x240 dolly with a keyframe at
least every second frame, so that a few frames reach the keyframe step.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from orbslam2_tpu_torch import profiling, synthetic
from orbslam2_tpu_torch.config import (
    CameraConfig, MapConfig, OrbConfig, SlamConfig, Sensor, SolverConfig, TrackingConfig,
)
from orbslam2_tpu_torch.pipeline.system import System
from orbslam2_tpu_torch.profiling import Span
from slambench import program_trace, tracing
from tests.torch_threads import share_cores

share_cores()

ROOT = Path(__file__).resolve().parents[1]
BENCH_SPANS = {"frame", "frame_build", "tracking", "mapping", "local_ba", "loop_closing"}


def _cfg(sensor: Sensor) -> SlamConfig:
    return SlamConfig(
        sensor=sensor,
        camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, width=320,
                            height=240),
        orb=OrbConfig(num_features=300, feature_slots=320, candidates_per_level=2048),
        map=MapConfig(max_keyframes=32, max_points=8192, max_local_points=2048),
        tracking=TrackingConfig(th_depth=40.0, kf_max_gap=2),
        solver=SolverConfig(ba_max_points=2048, local_ba_iters_first=3, local_ba_iters_second=4,
                            ba_max_local_kfs=16, ba_max_fixed_kfs=16),
    )


def _refuse(*args, **kwargs):
    raise AssertionError("the tracer is off")


def _program_events(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(program_trace.PROGRAM_PREFIX)]


@pytest.fixture(scope="module")
def rgbd():
    """Frames 0-1 with the tracer off (frame 1 under a CPU profiler), its
    clock and profiler range made to raise; then, tracer on and the
    benchmark's Recorder installed, frames 2-3 (a keyframe at frame 3),
    two loop candidates queued against the keyframe and verified on
    frames 4-5 under a CPU profiler (the keyframe's own step is their
    verification: the inlier gate is raised so that both are rejected)."""
    cfg = _cfg(Sensor.RGBD)
    seq = synthetic.textured_sequence(n_frames=6, kind="forward", cam=cfg.camera)
    slam = System(cfg, device="cpu")
    acts = [torch.profiler.ProfilerActivity.CPU]

    def hand(i):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)

    out = {}
    saved = profiling.now_ns, profiling._Range
    profiling.now_ns = profiling._Range = _refuse
    try:
        hand(0)
        with torch.profiler.profile(activities=acts) as prof:
            hand(1)
        out["off_events"] = len(_program_events(prof))
    finally:
        profiling.now_ns, profiling._Range = saved
    out["off"] = profiling.take()

    rec = tracing.Recorder()
    rec.install()
    rec.label = "spans"
    profiling.enable()
    try:
        for i in (2, 3):
            with rec.frame():
                hand(i)
        out["on"] = profiling.take()
        out["empty"] = profiling.take()
        lc = slam.loop_closer
        lc.cfg = dataclasses.replace(lc.cfg, solver=dataclasses.replace(
            lc.cfg.solver, sim3_min_inliers=10 ** 6))
        kf = max(lc._seq_of)
        lc._pending_verify = {"kf_id": kf, "seq": lc._seq_of[kf], "cands": [0, 0],
                              "cand_seqs": [lc._seq_of.get(0, -1)] * 2, "idx": 0,
                              "handles": None}
        lc._dispatch_next_verify(slam.map)
        out["queued"] = profiling.take()
        with torch.profiler.profile(activities=acts) as prof:
            for i in (4, 5):
                with rec.frame():
                    hand(i)
        out["verify"] = profiling.take()
        out["ranges"] = sorted(
            ((e.name()[len(program_trace.PROGRAM_PREFIX):],) + tracing._ns(e)
             for e in _program_events(prof)), key=lambda r: r[1])
    finally:
        profiling.disable()
        rec.uninstall()
    out["kf"] = kf
    out["slam"], out["rec"] = slam, rec
    return out


@pytest.fixture(scope="module")
def stereo():
    cfg = _cfg(Sensor.STEREO)
    seq = synthetic.textured_sequence(n_frames=4, kind="forward", cam=cfg.camera)
    slam = System(cfg, device="cpu", enable_loop_closing=False)
    profiling.take()
    profiling.enable()
    try:
        for i in range(4):
            left, right, _ = seq.stereo(i)
            slam.track_stereo(left, right, timestamp=i / 30.0)
    finally:
        profiling.disable()
    return slam, profiling.take()


@pytest.fixture(scope="module")
def localizing():
    """Frames 0-2 mapped (no loop closer, so relocalization has no
    database and fails), localization mode, then with the tracer on frame
    3 on the fused step and frame 4 on the odometry path (mbVO set by
    hand)."""
    cfg = _cfg(Sensor.RGBD)
    seq = synthetic.textured_sequence(n_frames=5, kind="forward", cam=cfg.camera)
    slam = System(cfg, device="cpu", enable_loop_closing=False)

    def hand(i):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)

    for i in range(3):
        hand(i)
    slam.activate_localization_mode()
    n_kf = slam.num_keyframes()
    profiling.take()
    profiling.enable()
    try:
        hand(3)
        slam.tracker.mb_vo = True
        hand(4)
    finally:
        profiling.disable()
    return slam, profiling.take(), n_kf


def _children(spans, i) -> list:
    return [s for s in spans if s.parent == i]


def _frames(spans) -> list:
    return [(i, s) for i, s in enumerate(spans) if s.name == "frame"]


def _assert_frame_trees(slam, spans, extracts: int):
    logged = {e["frame_id"] for e in slam.log.of("frame")}
    roots = _frames(spans)
    assert roots and all(s.parent == -1 for _, s in roots)
    assert all(s.parent >= 0 for s in spans if s.name != "frame" and s.frame_id >= 0)
    for i, root in roots:
        assert root.frame_id in logged
        names = [c.name for c in _children(spans, i)]
        assert names.count("frame.build") == 1, names
        assert {"tracking.step", "tracking.slow", "tracking.localization_vo"} & set(names), names
        build = next(j for j, s in enumerate(spans) if s.parent == i and s.name == "frame.build")
        assert [c.name for c in _children(spans, build)].count("frame.build.extract") == extracts
    for s in spans:
        if s.parent >= 0:
            up = spans[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns, (up, s)
            assert s.frame_id == up.frame_id or s.name == "session.resolve"


def _assert_keyframe_step(spans):
    kfs = [(i, s) for i, s in enumerate(spans) if s.name == "mapping.keyframe"]
    assert kfs
    for i, s in kfs:
        assert spans[s.parent].name == "frame"
        names = [c.name for c in _children(spans, i)]
        for stage in ("mapping.insert", "mapping.triangulate", "mapping.fuse",
                      "mapping.refresh", "mapping.local_ba", "mapping.redundancy"):
            assert stage in names, (stage, names)


def test_tracer_off_reads_no_clock_and_records_nothing(rgbd):
    assert rgbd["off"] == {"spans": [], "counters": {}}
    assert rgbd["off_events"] == 0
    assert len(rgbd["slam"].results) == 6


def test_rgbd_frames_are_span_trees(rgbd):
    spans = rgbd["on"]["spans"]
    _assert_frame_trees(rgbd["slam"], spans, extracts=1)
    assert sorted(s.frame_id for _, s in _frames(spans)) == [2, 3]
    _assert_keyframe_step(spans)
    names = {s.name for s in spans}
    assert {"tracking.coarse", "tracking.local_map", "session.decision_read",
            "frame.build.depth", "session.resolve", "mapping.after_keyframe"} <= names
    assert rgbd["on"]["counters"]["mapping.keyframes"] == 1
    assert rgbd["empty"] == {"spans": [], "counters": {}}


def test_stereo_frames_are_span_trees(stereo):
    slam, taken = stereo
    spans = taken["spans"]
    _assert_frame_trees(slam, spans, extracts=2)
    assert sorted(s.frame_id for _, s in _frames(spans)) == [0, 1, 2, 3]
    assert "frame.build.stereo_match" in {s.name for s in spans}
    _assert_keyframe_step(spans)
    assert profiling.take() == {"spans": [], "counters": {}}


def test_localization_frames_are_span_trees(localizing):
    slam, taken, n_kf = localizing
    spans = taken["spans"]
    _assert_frame_trees(slam, spans, extracts=1)
    assert sorted(s.frame_id for _, s in _frames(spans)) == [3, 4]
    loc = [i for i, s in enumerate(spans) if s.name == "tracking.localization_vo"]
    assert len(loc) == 1 and spans[spans[loc[0]].parent].frame_id == 4
    assert [c.name for c in _children(spans, loc[0])] == ["tracking.relocalize", "tracking.vo"]
    assert "tracking.step" in {c.name for c in _children(spans, 0)}
    counters = taken["counters"]
    assert counters["localization.frames"] == 2
    logged = [e["state"] for e in slam.log.of("frame") if e["frame_id"] in (3, 4)]
    assert counters["localization.vo"] == logged.count("VO") >= 1
    assert "localization.reloc_won" not in counters and "mapping.keyframes" not in counters
    assert slam.num_keyframes() == n_kf


def test_verification_spans_and_counters(rgbd):
    """Each verification's dispatch and read carry the keyframe and
    candidate; the rejection counters add up to the rejections the event
    log holds."""
    queued, spans = rgbd["queued"]["spans"], rgbd["verify"]["spans"]
    counters = dict(rgbd["verify"]["counters"])
    for k, v in rgbd["queued"]["counters"].items():
        counters[k] = counters.get(k, 0) + v
    kf = rgbd["kf"]
    verify = [s for s in queued + spans if s.name == "loop.verify"]
    reads = [s for s in spans if s.name == "loop.verify_read"]
    assert len(verify) == 2 and len(reads) == 2
    for s in verify + reads:
        assert (s.kf_id, s.cand) == (kf, 0)
    # the first dispatched between frames, the second by the first's read
    assert verify[0].parent == -1 and verify[0].frame_id == -1
    assert spans[verify[1].parent].name == "session.resolve" and verify[1].frame_id == 4
    assert [(spans[s.parent].name, s.frame_id) for s in reads] == [("session.resolve", 4),
                                                                  ("session.resolve", 5)]
    for s in spans:
        if s.name.startswith("loop.verify."):
            assert spans[s.parent].name == "loop.verify" and s.kf_id == kf
    assert [s.name for s in queued[1:]] == ["loop.verify.brute", "loop.verify.ransac",
                                            "loop.verify.extend", "loop.verify.optimize",
                                            "loop.verify.guided"]
    rejected = sum(v for k, v in counters.items() if k.startswith("loop.verify.rejected."))
    fails = rgbd["slam"].log.of("loop_sim3_fail")
    assert rejected == len(fails) == counters["loop.verify.dispatched"] == 2
    assert all(f["kf_id"] == kf and f["cand"] == 0 for f in fails)


def test_spans_agree_with_profiler_ranges(rgbd):
    """Under a CPU profiler each span opens its `orbslam2.*` range; past
    the first spans they agree at both ends within 0.1 ms."""
    spans, ranges = rgbd["verify"]["spans"], rgbd["ranges"]
    assert len(ranges) == len(spans)
    assert [r[0] for r in ranges] == [s.name for s in spans]
    gap = program_trace.clock_check(spans, [(n, s, s + d) for n, s, d in ranges], skip=5)
    assert gap is not None and gap < 100_000, gap


def test_benchmark_rebinding_still_records(rgbd):
    names = {name for label, name, _, _ in rgbd["rec"].spans if label == "spans"}
    assert names == BENCH_SPANS


# -- the benchmark's readers of the program's records -------------------------

def _span(name, a, b, parent=-1, frame_id=0, kf_id=-1, cand=-1):
    return Span(name, a, b, parent, frame_id, kf_id, cand, 0, 0)


def _trace():
    """Two profiled frames: frame 0 builds (an extraction inside) and
    tracks; frame 1 builds, tracks, makes a keyframe and verifies one
    candidate. Launch calls at known times; the span pass has read spans
    in two frames."""
    prof = [
        _span("frame", 0, 100),
        _span("frame.build", 0, 30, 0),
        _span("frame.build.extract", 5, 20, 1),
        _span("tracking.step", 30, 60, 0),
        _span("frame", 200, 400, frame_id=1),
        _span("frame.build", 200, 230, 4, 1),
        _span("tracking.step", 230, 260, 4, 1),
        _span("mapping.keyframe", 260, 330, 4, 1),
        _span("mapping.local_ba", 300, 320, 7, 1),
        _span("session.resolve", 330, 400, 4, 1),
        _span("mapping.after_keyframe", 330, 340, 9, 1),
        _span("loop.verify", 350, 390, 9, 1, kf_id=3, cand=1),
    ]
    launches = [1, 6, 7, 25, 31, 59, 60, 99, 150, 201, 240, 261, 305, 310, 335, 360, 361, 399]
    spans_pass = [
        _span("frame", 0, 10_000_000),
        _span("session.decision_read", 1_000_000, 3_000_000, 0),
        _span("frame", 20_000_000, 30_000_000, frame_id=1),
        _span("loop.verify_read", 21_000_000, 22_000_000, 2, 1),
        _span("tracking.coarse", 23_000_000, 25_000_000, 2, 1),
    ]
    profile = {"launches": launches, "device": [(40, 45), (55, 90), (140, 160)],
               "waits": [(31, 5)], "kernels": {},
               "ranges": {"frame": [(0, 100), (200, 400)], "tracking": [(30, 60)]}}
    program = {"spans": {"spans": spans_pass, "counters": {}},
               "profiled": {"spans": prof, "counters": {}}}
    return SimpleNamespace(program=program, profile=profile, frames=2, keyframes=1,
                           window=(0, 400))


def test_launch_attribution_takes_the_innermost_span():
    t = _trace()
    spans = t.program["profiled"]["spans"]
    inner = program_trace.innermost(spans, t.profile["launches"])
    names = [spans[i].name if i >= 0 else None for i in inner]
    assert names == ["frame.build", "frame.build.extract", "frame.build.extract", "frame.build",
                     "tracking.step", "tracking.step", "frame", "frame", None, "frame.build",
                     "tracking.step", "mapping.keyframe", "mapping.local_ba",
                     "mapping.local_ba", "mapping.after_keyframe", "loop.verify", "loop.verify",
                     "session.resolve"]
    totals = program_trace.attribute(spans, t.profile["launches"])
    assert totals[0] == 8 and totals[4] == 9 and totals[7] == 3 and totals[9] == 4
    table = program_trace.stage_table(spans, t.profile)
    assert table["frame.build"]["launches"] == 5
    assert table["tracking.step"]["wait_ms"] == 5 / 1e6
    assert table["frame"]["busy_ms"] == 40 / 1e6
    assert table["mapping.keyframe"]["self_ms"] == 50 / 1e6


@pytest.mark.parametrize("name, want", [
    ("frame_build.launches", 5 / 2), ("tracking.launches", 3 / 2),
    ("mapping.keyframe_launches", 4 / 1), ("loop_closing.verify_launches", 2 / 1),
    ("session.read_wait_ms", 3.0 / 2),
])
def test_readers_on_a_hand_built_trace(name, want):
    got = program_trace.read_new_metrics(ROOT, "tum3-rgbd.fr3-office", _trace())
    assert got[name]["value"] == pytest.approx(want)
    assert got[name]["unit"] == program_trace.NEW_METRICS[name]
    # a trace without the program's records (the harness as it stands) reads nothing
    bare = SimpleNamespace(profile={"launches": [1]}, frames=2, keyframes=1)
    assert program_trace.read_new_metrics(ROOT, "tum3-rgbd.fr3-office", bare) == {}


def test_idle_gaps_carry_the_program_span():
    t = _trace()
    gaps = [[label, round(d * 1e9)] for label, d in program_trace.labelled_gaps(t)]
    assert gaps == [["frame/mapping.keyframe", 240],   # 160 -> 400, the middle at 280
                    ["between frames", 50],            # 90 -> 140
                    ["frame/frame.build", 40],         # 0 -> 40
                    ["tracking/tracking.step", 10]]    # 45 -> 55
