"""The port runs without JAX, and its session refuses what it does not do."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.config import OrbConfig, SlamConfig, Sensor, TrackingConfig, VocabConfig
from orbslam2_tpu_torch.pipeline.system import System

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Neither jax nor any module of the reference package is loaded by the
    port's session, its converters, its kernels, its loop-closing and
    relocalization modules, its dataset loaders, native decoder, drawers,
    profiling and command-line runner, its sharded solvers and entry
    points, its long-run, scale and bench drivers, `chip_smoke.py`, the
    tool that times the relocalization warm-up, or the functions the
    parallel tests run in their ranks."""
    code = (
        "import sys\n"
        "import orbslam2_tpu_torch.pipeline.system, orbslam2_tpu_torch.convert, "
        "orbslam2_tpu_torch.kernels, chip_smoke\n"
        "import orbslam2_tpu_torch.pipeline.loop_closing, orbslam2_tpu_torch.vocab.bow, "
        "orbslam2_tpu_torch.vocab.database, orbslam2_tpu_torch.solvers.epnp, "
        "orbslam2_tpu_torch.solvers.horn, orbslam2_tpu_torch.solvers.sim3_opt, "
        "orbslam2_tpu_torch.solvers.pose_graph, orbslam2_tpu_torch.solvers.sym_eigh, "
        "orbslam2_tpu_torch.geometry.sim3\n"
        "import orbslam2_tpu_torch.datasets, orbslam2_tpu_torch.native, "
        "orbslam2_tpu_torch.viz.drawers, orbslam2_tpu_torch.profiling, orbslam2_tpu_torch.run, "
        "tools.reloc_warmup_timing\n"
        "import orbslam2_tpu_torch.parallel.group, orbslam2_tpu_torch.parallel.sharded_ba, "
        "orbslam2_tpu_torch.parallel.sharded_bow, orbslam2_tpu_torch.parallel.sharded_pose_graph, "
        "orbslam2_tpu_torch.graft_entry, tests.torch_ranks\n"
        "import orbslam2_tpu_torch.longrun, orbslam2_tpu_torch.scale, orbslam2_tpu_torch.bench\n"
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
    ("orbslam2_tpu/io/datasets.py", "orbslam2_tpu_torch/datasets.py"),
]
# the copies' references to the reference package, and the port's names
# for them
RENAMES = [
    ("from orbslam2_tpu.config import", "from orbslam2_tpu_torch.config import"),
    ("from orbslam2_tpu.native import", "from orbslam2_tpu_torch.native import"),
    ("from orbslam2_tpu.io.trajectory import", "from orbslam2_tpu_torch.trajectory import"),
    ("orbslam2_tpu/native/image_io.cc", "orbslam2_tpu_torch/native/image_io.cc"),
]


@pytest.mark.parametrize("ref,copy", COPIES, ids=[c[1].split("/")[-1] for c in COPIES])
def test_copied_module_equals_reference(ref, copy):
    """Each copy is its original line for line, but for its three-line
    header and its references to the port's own copies and modules."""
    want = (REPO / ref).read_text()
    for old, new in RENAMES:
        want = want.replace(old, new)
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


def test_cli_on_cuda_fails_without_gpu(tmp_path):
    """`python -m orbslam2_tpu_torch.run` defaults to the CUDA device, and
    without one exits non-zero before tracking a frame; it does not fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for extra in ([], ["--device", "cuda"]):
        out = tmp_path / "traj.txt"
        res = subprocess.run([sys.executable, "-m", "orbslam2_tpu_torch.run", "--dataset",
                              "synthetic", "--frames", "2", "--out", str(out), *extra],
                             cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert "no CUDA device" in res.stderr and res.stdout == "" and not out.exists()


def test_cuda_session_refuses_more_slots_than_the_pose_kernel_takes():
    """A frame's slots are K2's observations: a larger `feature_slots`
    fails when the session is made, not in its first tracked frame."""
    cfg = SlamConfig(orb=OrbConfig(feature_slots=kernels.POSE_GN_MAX_SLOTS + 256))
    with pytest.raises(ValueError, match="feature_slots"):
        System(cfg, device="cuda", enable_mapping=False, enable_loop_closing=False)


@pytest.mark.parametrize("kwargs,cfg", [
    # mapping and loop closing are ported; pipelining them is not
    ({"enable_mapping": True, "enable_loop_closing": True},
     SlamConfig(tracking=TrackingConfig(pipeline_depth=2))),
    ({"enable_mapping": False, "enable_loop_closing": True},
     SlamConfig(vocab=VocabConfig(vocab_file=None), tracking=TrackingConfig(pipeline_depth=1))),
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


@pytest.mark.parametrize("sensor", [Sensor.RGBD, Sensor.STEREO, Sensor.MONOCULAR])
def test_loop_closing_session_constructs(sensor):
    """Loop closing is on by default, for every sensor; the loop closer is
    made with the shipped vocabulary at the first keyframe it sees, or
    without a vocabulary file trains its own there."""
    slam = System(SlamConfig(sensor=sensor), device="cpu")
    assert slam.enable_mapping and slam.enable_loop_closing
    assert slam.loop_closer is None
    assert slam._vocab_path().endswith("orbslam2_tpu_torch/data/vocab.npz")
    for vocab_file in (None, "", "/nonexistent/vocab.npz"):
        own = System(SlamConfig(sensor=sensor, vocab=VocabConfig(vocab_file=vocab_file)),
                     device="cpu")
        assert own._vocab_path() is None and own._load_vocab_file() == (None, None)


def test_vocabulary_copy_equals_reference():
    """The port ships its own copy of the reference's vocabulary."""
    ref = (REPO / "orbslam2_tpu" / "data" / "vocab.npz").read_bytes()
    assert (REPO / "orbslam2_tpu_torch" / "data" / "vocab.npz").read_bytes() == ref


@pytest.mark.parametrize("sensor", [Sensor.STEREO, Sensor.MONOCULAR, Sensor.RGBD])
def test_session_constructs_for_sensor(sensor):
    """Every sensor's CPU session constructs, and localization mode is
    ported: it switches on and off, and the tracker reports the
    odometry's flag."""
    slam = System(SlamConfig(sensor=sensor), device="cpu", enable_loop_closing=False)
    assert slam.cfg.sensor == sensor
    assert slam.num_keyframes() == 0
    slam.activate_localization_mode()
    assert slam.localization_only and slam.tracker.mb_vo is False
    slam.deactivate_localization_mode()
    assert not slam.localization_only


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
