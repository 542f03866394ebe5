"""CPU tests of the benchmark harness (run: `python -m pytest slambench -q`).

They hold: the harness finds a configuration, a traffic mix and a
per-layer metric added as new files; the end-to-end, ATE and roofline
arithmetic on fixed inputs; the frozen renderer copy against the
program's renderer; the reference's frame build against the program's on
the CPU; and that nothing under `slambench/` imports JAX or the JAX
package. `test_slambench_checks.py` drives whole runs with faults planted.
"""

from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from slambench import cell, reference, render, roofline, run, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _tiny_root(tmp_path: Path) -> Path:
    """A checkout root whose BENCHMARK.json names a new configuration, a
    new mix and a new per-layer metric, each added as a file of its own."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "slambench" / "configs").mkdir(parents=True)
    (tmp_path / "slambench" / "traffic").mkdir()
    shutil.copytree(HERE / "metrics", tmp_path / "slambench" / "metrics")
    text = (HERE / "configs" / "tum3-rgbd.yaml").read_text()
    for key, value in {"Camera.fx": 267.7, "Camera.fy": 269.6, "Camera.cx": 160.05,
                       "Camera.cy": 123.8, "Camera.width": 320, "Camera.height": 240,
                       "Camera.bf": 20.0, "ORBextractor.nFeatures": 400,
                       "Port.feature_slots": 512, "Port.max_keyframes": 32,
                       "Port.max_points": 4096, "Port.max_local_points": 2048,
                       "Port.ba_max_points": 2048, "Port.ba_max_local_kfs": 8,
                       "Port.ba_max_fixed_kfs": 8}.items():
        lines = [f"{key}: {value}" if ln.startswith(f"{key}:") else ln
                 for ln in text.splitlines()]
        text = "\n".join(lines)
    (tmp_path / "slambench" / "configs" / "tiny-rgbd.yaml").write_text(text)
    mix = json.loads((HERE / "traffic" / "fr3-office.json").read_text())
    # the first session's 6 cm a frame and no pan, so that a fault shows within the few
    # frames a loaded CPU hands over in the tiny window
    mix["path"] = dict(mix["path"], speed_m_s=1.8, pan_deg_s=0.0)
    mix.update(session_frames=40, setup=[[0, 5]], sampled_frames=2, sample_span=4,
               window=[{"segments": [[6, 39]], "map": "continue"},
                       {"segments": [[0, 39]], "map": "fresh"}], profiled_frames=4)
    (tmp_path / "slambench" / "traffic" / "mini.json").write_text(json.dumps(mix))
    (tmp_path / "slambench" / "metrics" / "session.frames_seen.py").write_text(
        "def read(t):\n    return float(t.frames)\n")
    bench["configs"] = [{"name": "tiny-rgbd", "source": "test", "reduced": [], "why": "test",
                         "file": "slambench/configs/tiny-rgbd.yaml"}]
    bench["workloads"] = [{"name": "tiny-rgbd.mini", "config": "tiny-rgbd", "traffic": "mini",
                           "chips": 1, "why": "test"}]
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append("tiny-rgbd.mini")
    bench["per_layer"].append({"name": "session.frames_seen", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "session", "moves": "fps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_files_are_found(tmp_path):
    root = _tiny_root(tmp_path)
    c = cell.load_cell(root, "tiny-rgbd.mini")
    assert c.camera.width == 320 and c.mix["session_frames"] == 40
    cfg = c.slam_config()
    assert cfg.orb.feature_slots == 512 and cfg.map.max_keyframes == 32
    assert cfg.camera.fx == pytest.approx(267.7) and cfg.tracking.depth_map_factor == 1.0
    rec = tracing.Recorder()
    rec.spans = [("spans", "frame_build", 0, 3_000_000), ("spans", "tracking", 0, 2_000_000)]
    data = run.TraceData(rec, frames=2, keyframes=0, device_type="cpu")
    got = run.read_metrics(root, json.loads((root / "BENCHMARK.json").read_text()),
                           "tiny-rgbd.mini", data)
    assert got["session.frames_seen"]["value"] == 2.0
    assert got["frame_build.ms"]["value"] == pytest.approx(1.5)
    assert got["tracking.ms"]["value"] == pytest.approx(1.0)
    assert "mapping.keyframe_ms" not in got and "device.idle_share" not in got


def test_shipped_cells_load():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = cell.load_cell(ROOT, w["name"])
        cfg = c.slam_config()
        assert cfg.orb.feature_slots >= cfg.orb.num_features
        assert c.limits, f"{w['name']} has no limits"
        # set-up and the window's first pass are one session, every frame once
        n = int(c.mix["session_frames"])
        first = cell.frame_order(c.mix["setup"]) + cell.frame_order(c.mix["window"][0]["segments"])
        assert first == list(range(n)) and c.mix["window"][0]["map"] == "continue"
        assert render.trajectory(c.mix, c.fps).shape == (n, 4, 4)
    assert cell.frame_order([[70, 0], [1, 71]])[:3] == [70, 69, 68]


def test_sweep_follows_its_table():
    """The path's speed and mean turn rate are the mix's (here TUM
    fr3/long_office_household's), and its frames stay inside the room."""
    T = render.sweep_trajectory(2585, 30.0, 0.249, 10.73, 10.188, 15.0)
    c = reference.centers(T)
    step = np.linalg.norm(np.diff(c, axis=0), axis=1)
    assert np.allclose(T[0], np.eye(4))
    assert np.median(step) * 30.0 == pytest.approx(0.249, rel=1e-6)
    assert step.sum() == pytest.approx(0.249 * 2584 / 30.0, rel=1e-3)
    turn = reference.rotation_deg(T[1:], T[:-1])
    assert turn.mean() * 30.0 == pytest.approx(10.188, rel=0.02)
    assert c[:, 2].min() >= 0.0 and c[:, 2].max() <= 10.73 + 1e-9


def test_end_to_end_arithmetic():
    gt = render.sweep_trajectory(6, 30.0, 0.249, 10.73, 10.188, 15.0)
    est = gt.copy()
    # every camera centre moved by one offset: the alignment takes it away
    est[:, :3, 3] -= np.einsum("nij,j->ni", gt[:, :3, :3], np.array([0.003, 0.0, -0.002]))
    bent = gt.copy()
    bent[3, :3, 3] += np.array([0.0, 0.0, 0.012])

    def s(traj, window=True, n=6):
        return {"window": window, "tracked": [True] * n, "order": list(range(n)), "traj": traj[:n]}

    sessions = [s(est), s(bent), s(bent * 3, window=False)]
    ms = list(range(1, 21))                     # 20 frames of 1..20 ms
    m = run.end_to_end(ms, 4.0, sessions, gt, 12.5)
    assert m["fps"]["value"] == pytest.approx(5.0)
    assert m["frame_p95_ms"]["value"] == pytest.approx(19.05)
    # every tracked frame of the window's sessions, each aligned on its own
    e = np.concatenate([reference.aligned_errors(est, gt), reference.aligned_errors(bent, gt)])
    assert m["ate_mm"]["value"] == pytest.approx(1e3 * np.sqrt(np.mean(e ** 2)))
    assert 0 < m["ate_mm"]["value"] < 12.0
    assert reference.ate_rmse(est, gt) == pytest.approx(0.0, abs=1e-9)
    assert m["setup_s"]["value"] == 12.5


def test_roofline_arithmetic():
    # K1 at 4096 x 1024 is bound by its 16.9 MB output: 5.04 us
    assert roofline.k1_bound_s(4096, 1024) == pytest.approx((32 * 5120 + 4 * 4096 * 1024) / 3.35e12)
    # K2 at 1024 slots, 600 real, 4 x 10 iterations: bound by operations
    assert roofline.k2_bound_s(1024, 600, 4, 10) == pytest.approx(200 * 600 * 40 / 67e12)
    rec = tracing.Recorder()
    rec.k1 = [("profiled", 4096, 1024)] * 2
    rec.k2 = [("profiled", 1024, 600, 4, 10)]
    rec.profile = {"device": [(0, 10_000), (5_000, 20_000), (30_000, 40_000)],
                   "kernels": {"hamming_kernel(uint4 const*, ...)": [2, 16_000],
                               "void pose_gn_kernel<4>(...)": [1, 50_000]},
                   "waits": [(1_000, 500), (50_000, 700)],
                   "ranges": {"frame": [(0, 25_000), (25_000, 50_000)]}}
    data = run.TraceData(rec, frames=2, keyframes=0, device_type="cuda")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = run.read_metrics(ROOT, bench, "tum3-rgbd.fr3-office", data)
    k1 = 100 * 2 * roofline.k1_bound_s(4096, 1024) / 16e-6
    assert got["kernels.k1_roofline"]["value"] == pytest.approx(k1)
    assert got["kernels.k2_roofline"]["value"] == pytest.approx(
        100 * roofline.k2_bound_s(1024, 600, 4, 10) / 50e-6)
    # busy 0-20 us and 30-40 us of a 50 us window
    assert got["device.idle_share"]["value"] == pytest.approx(40.0)
    # the wait at 50 us starts where the last frame ends: not counted
    assert got["session.host_wait_share"]["value"] == pytest.approx(100 * 500 / 50_000)
    assert tracing.idle_gaps(rec.profile["device"], 0, 50_000) == [(20_000, 30_000),
                                                                   (40_000, 50_000)]


def test_renderer_copy_matches_program():
    import torch

    from orbslam2_tpu_torch import synthetic
    from orbslam2_tpu_torch.config import CameraConfig

    cam_p = CameraConfig(fx=60.0, fy=61.0, cx=31.5, cy=23.5, width=64, height=48, bf=6.0)
    cam_b = render.Camera(fx=60.0, fy=61.0, cx=31.5, cy=23.5, width=64, height=48, bf=6.0)
    world_p, world_b = synthetic.make_room(seed=9), render.make_room(seed=9)
    for qp, qb in zip(world_p.quads, world_b.quads, strict=True):
        assert np.array_equal(qp.origin, qb.origin) and np.array_equal(qp.eu, qb.eu)
        assert np.array_equal(qp.ev, qb.ev) and (qp.seed, qp.base) == (qb.seed, qb.base)
    T = render.sweep_trajectory(400, 30.0, 0.249, 10.73, 10.188, 15.0)[[0, 37, 150, 399]]
    img_b, dep_b = render.render_batch(world_b, torch.tensor(T), cam_b)
    for j in range(len(T)):
        img_p, dep_p = synthetic.render_textured(world_p, T[j], cam_p, noise=0.0)
        # the program's renderer returns float32; this one float64
        assert np.abs(img_p - img_b[j].numpy()).max() < 2e-5
        assert np.abs(dep_p - dep_b[j].numpy()).max() < 2e-6


def test_reference_frame_build_matches_program_on_cpu():
    import torch

    from orbslam2_tpu_torch import config as c
    from orbslam2_tpu_torch.ops import stereo
    from orbslam2_tpu_torch.ops.orb import OrbExtractor

    cam = render.Camera(fx=267.7, fy=269.6, cx=160.05, cy=123.8, width=320, height=240, bf=20.0)
    T = render.sweep_trajectory(3, 30.0, 0.249, 10.73, 10.188, 15.0)
    frames = render.session_frames(render.make_room(seed=9), T, cam, False, 1.0, 9, "cpu")
    img = frames["left"][2].astype(np.float32)
    dep = render.decode_depth(frames["depth"][2])
    f = OrbExtractor(c.OrbConfig(num_features=400, feature_slots=512))(torch.from_numpy(img))
    v = f.valid.numpy()
    _, desc = reference.descriptors(img, f.xy.numpy()[v], f.octave.numpy()[v], 1.2, 8)
    assert v.sum() > 300
    assert reference.popcount(f.desc.numpy()[v].view(np.uint32) ^ desc).sum() == 0
    # every keypoint is a FAST corner topping its 3x3 neighbourhood in the reference
    assert reference.keypoint_found(img, f.xy.numpy()[v], f.octave.numpy()[v], 1.2, 8, 7.0).all()
    moved = f.xy.numpy()[v] + np.float32(2.0) * np.float32(1.2) ** f.octave.numpy()[v][:, None]
    assert reference.keypoint_found(img, moved, f.octave.numpy()[v], 1.2, 8, 7.0).mean() < 0.2
    sm = stereo.compute_stereo_from_rgbd(f.xy, f.xy, f.valid, torch.from_numpy(dep), 1.0,
                                         torch.tensor(20.0))
    ref = reference.rgbd_depth(f.xy.numpy(), v, dep)
    assert (ref > 0).sum() > 200
    assert np.array_equal(sm.depth.numpy(), ref)


def test_pose_errors():
    gt = render.sweep_trajectory(4, 30.0, 0.249, 10.73, 0.0, 15.0)
    assert reference.rotation_deg(gt, gt).max() == pytest.approx(0.0, abs=1e-5)
    assert np.allclose(reference.centers(gt)[:, 2], 0.249 / 30.0 * np.arange(4), atol=1e-9)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) >= 12
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "flax", "orbslam2_tpu"}
        assert not bad, f"{path.name} imports {bad}"
    # top-level names compared whole: the port's name starts with the JAX package's
    assert "orbslam2_tpu_torch" in _imports(HERE / "run.py") | _imports(HERE / "tracing.py")
    assert run.forbidden_modules() == [] or "jax" in run.forbidden_modules()
