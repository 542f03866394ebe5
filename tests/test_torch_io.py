"""The port's host-side I/O against the reference's on the same files: the
TUM / KITTI / EuRoC loaders (`tests/test_datasets.py`), the native
PNG/PGM decoder and prefetcher (`tests/test_native_io.py`), the headless
drawers (`tests/test_viz.py`) and the profiling helpers. Every array the
two packages return from the same input is held exactly equal; the
reference's own checks run on the port's results too.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from orbslam2_tpu import native as jnative
from orbslam2_tpu.config import CameraConfig, SlamConfig as JSlamConfig
from orbslam2_tpu.io import datasets as jds
from orbslam2_tpu.io import synthetic
from orbslam2_tpu.io import trajectory as jtraj
from orbslam2_tpu.viz import drawers as jdrawers
from orbslam2_tpu_torch import datasets as tds
from orbslam2_tpu_torch import native as tnative
from orbslam2_tpu_torch import profiling as tprof
from orbslam2_tpu_torch import trajectory as ttraj
from orbslam2_tpu_torch.config import SlamConfig as TSlamConfig
from orbslam2_tpu_torch.viz import drawers as tdrawers

REPO = Path(__file__).resolve().parent.parent


def _write_png(path, arr, mode=None):
    from PIL import Image

    Image.fromarray(arr, mode=mode).save(path)


def assert_same(a, b):
    """Two packages' arrays: the same shape, dtype and values."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    np.testing.assert_array_equal(a, b)


# -- datasets (tests/test_datasets.py) -------------------------------------


@pytest.fixture
def tum_fixture(tmp_path):
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, depth_lines = [], []
    world = synthetic.make_world(n_points=400, seed=1)
    cam = CameraConfig(width=160, height=120, fx=120, fy=120, cx=79.5, cy=59.5)
    for i in range(4):
        t = 100.0 + i * 0.033
        img, depth = synthetic.render_frame(world, np.eye(4), cam)
        _write_png(str(root / "rgb" / f"{t:.6f}.png"), img.astype(np.uint8))
        d16 = (depth * 5000.0).astype(np.uint16)
        _write_png(str(root / "depth" / f"{t + 0.005:.6f}.png"), d16)
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t + 0.005:.6f} depth/{t + 0.005:.6f}.png")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(depth_lines) + "\n")
    (root / "groundtruth.txt").write_text(
        "# gt\n" + "\n".join(f"{100.0 + i * 0.033:.6f} 0 0 {i * 0.1:.3f} 0 0 0 1"
                             for i in range(4)) + "\n"
    )
    return str(root)


def test_tum_load_and_associate(tum_fixture):
    ref, port = jds.TumRgbdDataset(tum_fixture), tds.TumRgbdDataset(tum_fixture)
    assert len(port) == len(ref) == 4
    assert port.pairs == ref.pairs
    for i in range(4):
        for a, b in zip(port[i], ref[i]):
            assert_same(a, b)
    img, depth, t = port[0]
    assert img.shape == (120, 160) and depth.shape == (120, 160)
    assert img.dtype == np.float32
    assert t == pytest.approx(100.0)
    assert 0 < depth[depth > 0].min() < 50


def test_tum_ground_truth(tum_fixture):
    ts, poses = tds.TumRgbdDataset(tum_fixture).ground_truth()
    ts_r, poses_r = jds.TumRgbdDataset(tum_fixture).ground_truth()
    assert_same(ts, ts_r)
    assert_same(poses, poses_r)
    assert poses.shape == (4, 4, 4)
    np.testing.assert_allclose(poses[1][2, 3], -0.1, atol=1e-6)


def test_kitti_load(tmp_path, rng):
    root = tmp_path / "kitti"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    for i in range(3):
        for d in ("image_0", "image_1"):
            _write_png(str(root / d / f"{i:06d}.png"), rng.integers(0, 255, (40, 60), dtype=np.uint8))
    (root / "times.txt").write_text("".join(f"{i * 0.1:.6e}\n" for i in range(3)))
    ref, port = jds.KittiOdometryDataset(str(root)), tds.KittiOdometryDataset(str(root))
    assert len(port) == len(ref) == 3
    for i in range(3):
        for a, b in zip(port[i], ref[i]):
            assert_same(a, b)
    left, right, t = port[1]
    assert left.shape == (40, 60) and right.shape == (40, 60)
    assert t == pytest.approx(0.1)


def test_euroc_load(tmp_path, rng):
    root = tmp_path / "euroc"
    for cam in ("cam0", "cam1"):
        d = root / "mav0" / cam / "data"
        d.mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(3):
            ts = 1403636579763555584 + i * 50000000
            _write_png(str(d / f"{ts}.png"), rng.integers(0, 255, (30, 40), dtype=np.uint8))
            lines.append(f"{ts},{ts}.png")
        (root / "mav0" / cam / "data.csv").write_text("\n".join(lines) + "\n")
    ref, port = jds.EurocDataset(str(root)), tds.EurocDataset(str(root))
    assert len(port) == len(ref) == 3
    for i in range(3):
        for a, b in zip(port[i], ref[i]):
            assert_same(a, b)
    left, _, t = port[0]
    assert left.shape == (30, 40)
    assert t == pytest.approx(1403636579.763555584, abs=1e-3)


def test_tum_trajectory_roundtrip(tmp_path, rng):
    """What the port writes, either package reads back, and the reverse."""
    from orbslam2_tpu_torch.geometry import se3

    import torch

    poses = se3.exp_se3(torch.from_numpy(rng.normal(0, 0.3, (5, 6)).astype(np.float32))).numpy()
    ts = np.arange(5, dtype=np.float64)
    p_port, p_ref = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    ttraj.save_tum(p_port, ts, poses)
    jtraj.save_tum(p_ref, ts, poses)
    assert Path(p_port).read_text() == Path(p_ref).read_text()
    ts2, poses2 = ttraj.load_tum(p_port)
    np.testing.assert_allclose(ts, ts2, atol=1e-6)
    np.testing.assert_allclose(poses, poses2, atol=1e-4)


# -- the native decoder (tests/test_native_io.py) ---------------------------


@pytest.fixture
def decoders():
    """Both packages' native decoders; the port's must build here."""
    assert tnative.native_available(), tnative.build_error()
    if not jnative.native_available():
        pytest.skip("the reference's native decoder did not build")
    return jnative, tnative


def test_native_source_is_a_copy():
    """The port's `image_io.cc` is the reference's, byte for byte, and its
    library builds under the package's `_build/`, not beside the source."""
    src = REPO / "orbslam2_tpu_torch" / "native" / "image_io.cc"
    assert src.read_bytes() == (REPO / "orbslam2_tpu" / "native" / "image_io.cc").read_bytes()
    from orbslam2_tpu_torch.native import imageio

    assert imageio._lib_path().parent == REPO / "orbslam2_tpu_torch" / "_build"
    assert tnative.native_available() and tnative.build_error() is None
    assert not list(src.parent.glob("*.so"))


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb", "pgm"])
def test_decode_matches_reference(decoders, tmp_path, rng, kind):
    """8- and 16-bit grayscale and RGB PNGs and a binary PGM: the two
    decoders give equal arrays, and the reference test's bars against PIL
    hold."""
    ref, port = decoders
    p = str(tmp_path / f"x.{'pgm' if kind == 'pgm' else 'png'}")
    if kind == "gray8":
        arr = rng.integers(0, 255, (37, 53), dtype=np.uint8)
        _write_png(p, arr)
        expect, tol = arr.astype(np.float32), 0.5
    elif kind == "gray16":
        arr = rng.integers(0, 65535, (24, 31), dtype=np.uint16)
        _write_png(p, arr)
        expect, tol = arr.astype(np.float32), 0.5
    elif kind == "rgb":
        arr = rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)
        _write_png(p, arr)
        expect = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
        tol = 1.0
    else:
        arr = rng.integers(0, 255, (16, 18), dtype=np.uint8)
        with open(p, "wb") as f:
            f.write(b"P5\n18 16\n255\n")
            f.write(arr.tobytes())
        expect, tol = arr.astype(np.float32), 0.5
    out = port.decode_image(p)
    assert out is not None
    assert_same(out, ref.decode_image(p))
    np.testing.assert_allclose(out, expect, atol=tol)


def test_decode_missing_file(decoders):
    ref, port = decoders
    assert port.decode_image("/nonexistent/nope.png") is None
    assert ref.decode_image("/nonexistent/nope.png") is None


def test_prefetcher_ordered_access(decoders, tmp_path, rng):
    ref, port = decoders
    paths, truth = [], []
    for i in range(12):
        arr = rng.integers(0, 255, (10, 10), dtype=np.uint8)
        p = str(tmp_path / f"{i}.png")
        _write_png(p, arr)
        paths.append(p)
        truth.append(arr)
    pf, pr = port.Prefetcher(paths, n_threads=3, max_ahead=4), ref.Prefetcher(paths, n_threads=3,
                                                                              max_ahead=4)
    try:
        for i in range(12):
            out = pf.get(i)
            assert_same(out, pr.get(i))
            np.testing.assert_allclose(out, truth[i].astype(np.float32), atol=0.5)
    finally:
        pf.close()
        pr.close()


# -- drawers (tests/test_viz.py) --------------------------------------------


def test_frame_drawer(rng):
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = rng.uniform(10, 100, (30, 2)).astype(np.float32)
    tracked = rng.uniform(0, 1, 30) > 0.5
    out = tdrawers.FrameDrawer(TSlamConfig()).draw(img, xy, tracked, state_text="OK KFs:3")
    ref = jdrawers.FrameDrawer(JSlamConfig()).draw(img, xy, tracked, state_text="OK KFs:3")
    assert out.size == (160, 120)
    arr = np.asarray(out)
    assert_same(arr, np.asarray(ref))
    assert ((arr[..., 1] > 200) & (arr[..., 0] < 50)).any()


def test_map_drawer(rng):
    P, K = 200, 4
    mp = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    valid = np.ones(P, bool)
    kf = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf[:, 0, 3] = np.arange(K) * 0.5
    kfv = np.ones(K, bool)
    covis = np.full((K, K), 150, np.int32)
    parent = np.asarray([-1, 0, 1, 2], np.int32)
    args = (mp, valid, kf, kfv)
    kw = dict(covis=covis, kf_parent=parent, current_Tcw=np.eye(4))
    arr = np.asarray(tdrawers.MapDrawer(TSlamConfig(), size=256).draw(*args, **kw))
    assert_same(arr, np.asarray(jdrawers.MapDrawer(JSlamConfig(), size=256).draw(*args, **kw)))
    assert arr.shape == (256, 256, 3)
    assert (arr.sum(-1) < 200).any()
    assert ((arr[..., 2] > 200) & (arr[..., 0] < 100)).any()
    assert ((arr[..., 0] > 200) & (arr[..., 2] < 100)).any()


def test_map_drawer_empty():
    args = (np.zeros((10, 3)), np.zeros(10, bool), np.tile(np.eye(4), (2, 1, 1)), np.zeros(2, bool))
    arr = np.asarray(tdrawers.MapDrawer(TSlamConfig(), size=64).draw(*args))
    assert_same(arr, np.asarray(jdrawers.MapDrawer(JSlamConfig(), size=64).draw(*args)))
    assert arr.shape == (64, 64, 3)


# -- profiling (orbslam2_tpu/utils/profiling.py) -----------------------------


def test_stage_timer_summary_matches_reference():
    """The same recorded stage times give the reference's summary; a wrapped
    call and a timed block each add one time, on the CPU without a
    synchronize."""
    from orbslam2_tpu.utils import profiling as jprof

    times = {"extract": [0.012, 0.0081, 0.0079, 0.0085], "track": [0.02]}
    port, ref = tprof.StageTimer("cpu"), jprof.StageTimer()
    for timer in (port, ref):
        for k, v in times.items():
            timer.times[k].extend(v)
    assert port.summary() == ref.summary()
    assert port.wrap("extract", lambda x: x + 1)(1) == 2
    with port.stage("track"):
        pass
    assert [len(port.times[k]) for k in ("extract", "track")] == [5, 2]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    with tprof.device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in k.key for k in prof.key_averages())
    assert os.path.getsize(tmp_path / "trace.json") > 0
