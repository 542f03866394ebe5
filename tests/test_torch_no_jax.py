"""The port runs without JAX, and its session refuses what it does not do."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.config import OrbConfig, SlamConfig, Sensor, TrackingConfig
from orbslam2_tpu_torch.pipeline.system import System

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Neither jax nor any module of the reference package is loaded by the
    port's session, its converters, its kernels or `chip_smoke.py`."""
    code = (
        "import sys\n"
        "import orbslam2_tpu_torch.pipeline.system, orbslam2_tpu_torch.convert, "
        "orbslam2_tpu_torch.kernels, chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'orbslam2_tpu')\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_lines_in_port():
    """No import line of jax or of the reference package in the port or in
    `chip_smoke.py`, at any indentation."""
    pkg = REPO / "orbslam2_tpu_torch"
    sources = [p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts]
    assert len(sources) > 15
    for path in [*sources, REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                top = words[1].split(".")[0]
                assert top not in ("jax", "orbslam2_tpu"), (path, line)


# (reference module, the port's copy): the port copies the reference's
# jax-free modules instead of importing them
COPIES = [
    ("orbslam2_tpu/config.py", "orbslam2_tpu_torch/config.py"),
    ("orbslam2_tpu/io/synthetic.py", "orbslam2_tpu_torch/synthetic.py"),
    ("orbslam2_tpu/io/trajectory.py", "orbslam2_tpu_torch/trajectory.py"),
    ("orbslam2_tpu/utils/evaluation.py", "orbslam2_tpu_torch/evaluation.py"),
    ("orbslam2_tpu/utils/eventlog.py", "orbslam2_tpu_torch/eventlog.py"),
]


@pytest.mark.parametrize("ref,copy", COPIES, ids=[c[1].split("/")[-1] for c in COPIES])
def test_copied_module_equals_reference(ref, copy):
    """Each copy is its original line for line, but for its three-line
    header and its imports of the other copies."""
    want = (REPO / ref).read_text().replace("from orbslam2_tpu.config import",
                                            "from orbslam2_tpu_torch.config import")
    got = (REPO / copy).read_text().split("\n", 3)
    assert all(line.startswith("# ") for line in got[:3])
    assert got[3] == want


def test_config_conversion_keeps_every_field():
    """The tests' conversion of a reference config gives the port's classes
    with the same values, enums by name."""
    import dataclasses

    from orbslam2_tpu import config as ref_config
    from orbslam2_tpu_torch import config as port_config_module
    from tests.torch_config import port_config

    ref = ref_config.SlamConfig(sensor=ref_config.Sensor.STEREO)
    got = port_config(ref)
    assert type(got) is port_config_module.SlamConfig
    assert got.sensor is port_config_module.Sensor.STEREO
    assert dataclasses.asdict(got) == {
        k: (v if not hasattr(v, "name") else port_config_module.Sensor[v.name])
        for k, v in dataclasses.asdict(ref).items()}


def test_cuda_session_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(SlamConfig(), device="cuda", enable_mapping=False, enable_loop_closing=False)


def test_cuda_session_refuses_more_slots_than_the_pose_kernel_takes():
    """A frame's slots are K2's observations: a larger `feature_slots`
    fails when the session is made, not in its first tracked frame."""
    cfg = SlamConfig(orb=OrbConfig(feature_slots=kernels.POSE_GN_MAX_SLOTS + 256))
    with pytest.raises(ValueError, match="feature_slots"):
        System(cfg, device="cuda", enable_mapping=False, enable_loop_closing=False)


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
