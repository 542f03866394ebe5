"""orbslam2_tpu_torch — the PyTorch/CUDA port of orbslam2_tpu for NVIDIA
Hopper GPUs.

The port mirrors the reference package's layout module for module; the
reference's Pallas kernels are hand-written CUDA here (`csrc/`, built and
loaded by `kernels.py`), each beside its plain PyTorch version. It imports
torch, never jax.

The reference package's modules that import no jax are shared rather than
copied, and re-exported here so that a program driving the port imports
nothing of the reference package itself: `config`, `synthetic` and
`trajectory` (from `orbslam2_tpu.io`), `evaluation` and `eventlog` (from
`orbslam2_tpu.utils`).

Ported so far: tracking and local mapping for the RGB-D, stereo and
monocular sensors with loop closing off (`pipeline.system.System(cfg,
device, enable_mapping=True, enable_loop_closing=False)`), trajectory
export and map save / load.
"""

from orbslam2_tpu import config
from orbslam2_tpu.io import synthetic, trajectory
from orbslam2_tpu.utils import evaluation, eventlog

__all__ = ["config", "synthetic", "trajectory", "evaluation", "eventlog"]
