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
    ({"enable_mapping": True, "enable_loop_closing": False}, SlamConfig()),
    ({"enable_mapping": False, "enable_loop_closing": True}, SlamConfig()),
    ({"enable_mapping": False, "enable_loop_closing": False},
     SlamConfig(tracking=TrackingConfig(pipeline_depth=1))),
    ({"enable_mapping": False, "enable_loop_closing": False}, SlamConfig(sensor=Sensor.STEREO)),
], ids=["mapping", "loop_closing", "pipelined", "stereo"])
def test_unported_modes_raise(kwargs, cfg):
    with pytest.raises(NotImplementedError):
        System(cfg, device="cpu", **kwargs)
