"""orbslam2_tpu_torch — the PyTorch/CUDA port of orbslam2_tpu for NVIDIA
Hopper GPUs.

The port mirrors the reference package's layout module for module; the
reference's Pallas kernels are hand-written CUDA here (`csrc/`, built and
loaded by `kernels.py`), each beside its plain PyTorch version. It imports
torch, never jax, and nothing of the reference package.

The reference package's modules that import no jax are copied rather than
imported (`config`, `synthetic`, `trajectory`, `evaluation`, `eventlog`,
`datasets`, and the native decoder's C++ source), so that the port imports
nothing of the reference package; a test holds each copy equal to its
original.

Ported so far: tracking, local mapping, relocalization and loop closing
for the RGB-D, stereo and monocular sensors (`pipeline.system.System(cfg,
device)`), localization mode, trajectory export and map save / load, and
the front door: the TUM / KITTI / EuRoC loaders, the native image decoder,
the headless drawers, profiling and the command-line runner
(`python -m orbslam2_tpu_torch.run`).
"""

from orbslam2_tpu_torch import config, evaluation, eventlog, synthetic, trajectory

__all__ = ["config", "synthetic", "trajectory", "evaluation", "eventlog"]
