"""The port's session drivers on the CPU at a tiny size: each prints one
JSON line that carries every key its JAX driver prints (`stress_longrun.py:125-146`,
`stress_scale.py:147-168`, `bench.py:216-257` with `--all-sensors`, and
with `--profile` its `stages` block), plus `pipeline_depth`: 0 when asked
for, and for `bench` and `longrun` by default 2, their JAX drivers' depth.
The sizes are cut here (a few frames, a small map, no loop-closer
warm-ups, frames rendered in the test's process); the keys do not depend
on them."""

import dataclasses
import json

import pytest

from orbslam2_tpu_torch import bench, config, drive, longrun, scale
from tests.torch_threads import share_cores

share_cores()

LONGRUN_KEYS = {"metric", "frames", "fps_overall", "ate_rmse_m", "lost_frames", "keyframes_live",
                "keyframes_inserted", "vocab_words", "points_live", "loops_closed",
                "edge_truncations", "obs_truncations", "fps_decay", "event_counts",
                "lost_at_frames", "loop_closed_at_kfs", "max_frame_ms", "p99_frame_ms", "device",
                "note"}
SCALE_EXTRA_KEYS = {"K", "P", "obs_slots", "edges_total", "obs_truncated", "build_s",
                    "reconcile_s", "edges_s", "pose_graph_3it_s", "global_ba_2it_s", "gba_cost",
                    "peak_rss_gb", "device"}
SEGMENT_KEYS = {"fps", "frames", "ate_rmse_m", "keyframes", "points"}
BENCH_EXTRA_KEYS = {"frames", "ate_rmse_m", "lost_frames", "loops_closed", "forward",
                    "orbit_loop", "scene", "device", "stereo_fps", "mono_fps"}
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


def _tiny(cfg):
    """`cfg` at 320x240 with 300 features, a 16-slot map and no warm-ups."""
    return dataclasses.replace(
        cfg,
        camera=config.CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, fps=30.0,
                                   width=320, height=240),
        orb=dataclasses.replace(cfg.orb, num_features=300, feature_slots=320,
                                candidates_per_level=2048),
        map=config.MapConfig(max_keyframes=16, max_points=4096, max_local_points=2048),
        solver=dataclasses.replace(cfg.solver, ba_max_points=1024),
        vocab=config.VocabConfig())


@pytest.fixture(autouse=True)
def _render_here(monkeypatch):
    """Frames rendered in the test's own process."""
    monkeypatch.setattr(drive, "RENDER_WORKERS", 0)


def _line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _longrun(monkeypatch, capsys, *depth):
    full = longrun.longrun_config
    monkeypatch.setattr(longrun, "longrun_config", lambda: _tiny(full()))
    monkeypatch.setattr(longrun, "WARMUP", 1)
    longrun.main(["--frames", "3", "--device", "cpu", *depth])
    out = _line(capsys)
    assert LONGRUN_KEYS <= out.keys()
    assert out["frames"] == 3 and out["device"] == "cpu"
    return out


def _scale(monkeypatch, capsys, *depth):
    monkeypatch.setattr(scale, "KEYFRAMES", 32)
    monkeypatch.setattr(scale, "POINTS", 1024)
    scale.main(["--device", "cpu"])
    out = _line(capsys)
    assert HEADLINE_KEYS <= out.keys() and SCALE_EXTRA_KEYS <= out["extra"].keys()
    assert out["extra"]["K"] == 32 and out["extra"]["device"] == "cpu"
    return out


def _bench(monkeypatch, capsys, *depth):
    full = bench.base_config
    monkeypatch.setattr(bench, "base_config", lambda: _tiny(full()))
    for name, value in (("FORWARD", 3), ("ORBIT", 2), ("REVISIT", 1), ("WARMUP", 1),
                        ("SENSOR_FRAMES", 3)):
        monkeypatch.setattr(bench, name, value)
    bench.main(["--all-sensors", "--device", "cpu", *depth])
    out = _line(capsys)
    extra = out["extra"]
    assert HEADLINE_KEYS <= out.keys() and BENCH_EXTRA_KEYS <= extra.keys()
    assert SEGMENT_KEYS <= extra["forward"].keys()
    assert SEGMENT_KEYS | {"loops_closed", "worst_frame_ms"} <= extra["orbit_loop"].keys()
    assert extra["frames"] == (3 - 1) + (3 - 1) and extra["device"] == "cpu"
    return out


def _bench_profile(monkeypatch, capsys, *depth):
    """`--profile`: bench.py's `stages` block, and the host's waits over
    the traced frames of segment B, keyframe frames and others apart."""
    full = bench.base_config
    monkeypatch.setattr(bench, "base_config", lambda: _tiny(full()))
    for name, value in (("PROFILE_FORWARD", 3), ("ORBIT", 2), ("REVISIT", 1), ("WARMUP", 1),
                        ("PROFILE_WINDOW", (1, 3))):
        monkeypatch.setattr(bench, name, value)
    bench.main(["--profile", "--device", "cpu", *depth])
    out = _line(capsys)
    extra = out["extra"]
    assert {"n", "first_ms", "steady_ms"} <= extra["stages"]["frame+track+kf"].keys()
    waits = extra["host_wait"]
    assert waits["window"] == [1, 3]
    assert waits["keyframe_frames"]["frames"] + waits["other_frames"]["frames"] == 2
    return out


SYNC = ("--pipeline-depth", "0")


@pytest.mark.parametrize("driver,args,depth", [
    (_longrun, SYNC, 0), (_scale, (), 0), (_bench, SYNC, 0), (_bench_profile, SYNC, 0),
    (_longrun, (), 2), (_bench, (), 2),
], ids=["longrun", "scale", "bench", "bench-profile", "longrun-depth2", "bench-depth2"])
def test_driver_line_has_reference_keys(driver, args, depth, monkeypatch, capsys):
    """The session's JSON line: its JAX counterpart's keys and its
    `pipeline_depth` (`scale` builds its map directly: 0)."""
    assert driver(monkeypatch, capsys, *args)["pipeline_depth"] == depth
