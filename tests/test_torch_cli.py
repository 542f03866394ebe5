"""The port's command-line runner (`python -m orbslam2_tpu_torch.run`) on
the CPU: the synthetic sequence and a TUM-layout directory written from
the synthetic renderer (8-bit RGB PNGs, 16-bit depth at 5000 counts per
metre, `rgb.txt`, `depth.txt`, `groundtruth.txt` and an ORB-SLAM2 YAML),
as `tests/test_datasets.py::test_tum_directory_end_to_end` builds it.
Marked slow: the same runs through the reference's runner, whose
trajectory the port's matches within 5 mm per frame."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from orbslam2_tpu.config import CameraConfig
from orbslam2_tpu.io import synthetic
from orbslam2_tpu_torch import trajectory as ttraj
from orbslam2_tpu_torch.evaluation import ate_rmse
from orbslam2_tpu_torch.run import main as run_main
from tests.torch_threads import share_cores

share_cores()

REPO = Path(__file__).resolve().parent.parent
CAM = CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0, fps=30.0,
                   width=320, height=240)
T0 = 1000.0
DT_M = 5e-3


def write_tum_directory(root: Path, n: int):
    """The textured dolly at 320x240 in TUM RGB-D's layout; returns the
    sequence."""
    from PIL import Image

    seq = synthetic.textured_sequence(n_frames=n, kind="forward", cam=CAM)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb, depth_lines = [], []
    for i in range(n):
        t = T0 + i / 30.0
        img, depth = seq.frame(i)
        g = np.clip(img, 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([g] * 3, axis=-1)).save(root / "rgb" / f"{t:.6f}.png")
        Image.fromarray((depth * 5000.0).astype(np.uint16)).save(root / "depth" / f"{t:.6f}.png")
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(depth_lines) + "\n")
    ttraj.save_tum(str(root / "groundtruth.txt"), T0 + np.arange(n) / 30.0, seq.poses)
    (root / "settings.yaml").write_text(
        "%YAML:1.0\n"
        "Camera.fx: 240.0\nCamera.fy: 240.0\nCamera.cx: 159.5\nCamera.cy: 119.5\n"
        "Camera.bf: 24.0\nCamera.fps: 30.0\nCamera.width: 320\nCamera.height: 240\n"
        "ORBextractor.nFeatures: 500\n"
        "ThDepth: 40.0\nDepthMapFactor: 5000.0\n"
    )
    return seq


def run_json(main, argv, capsys) -> dict:
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def reference_keys() -> set:
    """The keys of the reference runner's JSON line, read from its source."""
    src = (REPO / "orbslam2_tpu" / "run.py").read_text()
    block = src[src.index("print(json.dumps({"):]
    block = block[:block.index("}))")]
    return set(re.findall(r'^\s*"(\w+)":', block, re.M))


def test_cli_synthetic_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "traj.txt")
    res = run_json(run_main, ["--dataset", "synthetic", "--frames", "6", "--device", "cpu",
                              "--out", out, "--viz", str(tmp_path / "viz")], capsys)
    assert set(res) == reference_keys() | {"device", "decoder", "decoder_error"}
    assert res["frames"] == 6 and res["state"] == "OK" and res["device"] == "cpu"
    assert res["decoder"] is None and res["events"]["frame"] == 6
    ts, poses = ttraj.load_tum(out)
    assert len(ts) == 6
    seq = synthetic.default_sequence(n_frames=6, kind="forward", cam=CameraConfig(
        fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=240.0))
    assert ate_rmse(poses, seq.poses, align=True) < 0.03
    assert sorted(p.name for p in (tmp_path / "viz").iterdir()) == ["frame_00000.png",
                                                                     "map_00000.png"]


def test_cli_tum_directory_on_cpu(tmp_path, capsys):
    """Six frames of a TUM-layout directory: every frame tracked, the
    native decoder in use, the depth factor applied once (ATE < 0.05 m,
    the reference test's bar)."""
    root = tmp_path / "tum"
    seq = write_tum_directory(root, 6)
    out = str(tmp_path / "traj.txt")
    res = run_json(run_main, ["--dataset", "tum", "--root", str(root), "--settings",
                              str(root / "settings.yaml"), "--out", out, "--device", "cpu"],
                   capsys)
    assert res["frames"] == 6 and res["state"] == "OK"
    assert res["decoder"] == "native" and res["decoder_error"] is None
    ts, poses = ttraj.load_tum(out)
    assert len(ts) == 6
    idx = np.round((np.asarray(ts) - T0) * 30.0).astype(int)
    assert ate_rmse(poses, seq.poses[idx], align=True) < 0.05


def test_cli_refuses_a_missing_root(tmp_path):
    with pytest.raises(FileNotFoundError):
        run_main(["--dataset", "tum", "--root", str(tmp_path / "none"), "--device", "cpu"])


def _compare_with_reference(tmp_path, capsys, argv):
    from orbslam2_tpu.run import main as ref_main

    p_out, r_out = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    port = run_json(run_main, argv + ["--out", p_out, "--device", "cpu"], capsys)
    ref = run_json(ref_main, argv + ["--out", r_out], capsys)
    assert set(port) == set(ref) | {"device", "decoder", "decoder_error"}
    for k in ("frames", "state", "keyframes", "loops_closed"):
        assert port[k] == ref[k], k
    ts_p, poses_p = ttraj.load_tum(p_out)
    ts_r, poses_r = ttraj.load_tum(r_out)
    np.testing.assert_allclose(ts_p, ts_r, atol=1e-6)
    assert np.linalg.norm(poses_p[:, :3, 3] - poses_r[:, :3, 3], axis=1).max() < DT_M


@pytest.mark.slow
def test_cli_synthetic_matches_reference(tmp_path, capsys):
    _compare_with_reference(tmp_path, capsys, ["--dataset", "synthetic", "--frames", "6"])


@pytest.mark.slow
def test_cli_tum_directory_matches_reference(tmp_path, capsys):
    """`test_tum_directory_end_to_end`'s 14-frame directory through both
    runners."""
    root = tmp_path / "tum"
    write_tum_directory(root, 14)
    _compare_with_reference(tmp_path, capsys, ["--dataset", "tum", "--root", str(root),
                                               "--settings", str(root / "settings.yaml")])
