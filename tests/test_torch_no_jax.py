"""The port runs without JAX, and its session refuses what it does not do."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orbslam2_tpu.config import SlamConfig, Sensor, TrackingConfig
from orbslam2_tpu_torch.pipeline.system import System

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import orbslam2_tpu_torch.pipeline.system, orbslam2_tpu_torch.convert, "
        "orbslam2_tpu_torch.kernels\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_lines_in_port():
    pkg = REPO / "orbslam2_tpu_torch"
    sources = [p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts]
    assert len(sources) > 15
    for path in sources:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), (path, line)


def test_cuda_session_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(SlamConfig(), device="cuda", enable_mapping=False, enable_loop_closing=False)


@pytest.mark.parametrize("kwargs,cfg", [
    # mapping is ported; mapping with loop closing is not
    ({"enable_mapping": True, "enable_loop_closing": True}, SlamConfig()),
    ({"enable_mapping": False, "enable_loop_closing": True}, SlamConfig()),
    ({"enable_mapping": False, "enable_loop_closing": False},
     SlamConfig(tracking=TrackingConfig(pipeline_depth=1))),
    # stereo and mono sessions are ported; pipelining them is not
    ({"enable_mapping": True, "enable_loop_closing": False},
     SlamConfig(sensor=Sensor.STEREO, tracking=TrackingConfig(pipeline_depth=1))),
    ({"enable_mapping": True, "enable_loop_closing": False},
     SlamConfig(sensor=Sensor.MONOCULAR, tracking=TrackingConfig(pipeline_depth=1))),
], ids=["mapping", "loop_closing", "pipelined", "stereo", "mono_pipelined"])
def test_unported_modes_raise(kwargs, cfg):
    with pytest.raises(NotImplementedError):
        System(cfg, device="cpu", **kwargs)


@pytest.mark.parametrize("sensor", [Sensor.STEREO, Sensor.MONOCULAR])
def test_session_constructs_for_sensor(sensor):
    slam = System(SlamConfig(sensor=sensor), device="cpu", enable_loop_closing=False)
    assert slam.cfg.sensor == sensor
    assert slam.num_keyframes() == 0
    with pytest.raises(NotImplementedError):
        slam.activate_localization_mode()


@pytest.mark.parametrize("sensor", [Sensor.RGBD, Sensor.STEREO, Sensor.MONOCULAR])
def test_track_entry_must_match_sensor(sensor):
    """Each session takes frames only through its own sensor's entry point."""
    slam = System(SlamConfig(sensor=sensor), device="cpu", enable_loop_closing=False)
    img = torch.zeros(8, 8)
    calls = {
        Sensor.RGBD: lambda: slam.track_rgbd(img, img),
        Sensor.STEREO: lambda: slam.track_stereo(img, img),
        Sensor.MONOCULAR: lambda: slam.track_monocular(img),
    }
    for other, call in calls.items():
        if other != sensor:
            with pytest.raises(ValueError, match=f"{other.name} frame in a {sensor.name}"):
                call()
    assert slam.results == []
