"""Time this checkout's K1 and K2 against another checkout's, in one run.

    python3 tools/time_kernels.py OTHER_CHECKOUT

Run from the repository root on a machine with an NVIDIA GPU and nvcc.
OTHER_CHECKOUT is a tree of this repository at another commit (for
example the parent, unpacked with `git archive`). Both sets of kernel
sources (`orbslam2_tpu_torch/csrc/hamming.cu` and `pose_gn.cu`) are built
as they are, each result is held to the plain version (K1 exact, K2 Tcw
within `chip_smoke.TOL_K2_TCW` with equal inliers), and each kernel is
timed at the paths' shapes in the order other, this, this, other. Every
time is `chip_smoke.device_ms`'s device time: 50 launches in one CUDA
graph, the replay timed with CUDA events.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from orbslam2_tpu_torch import config, drive, kernels  # noqa: E402
from orbslam2_tpu_torch.geometry.camera import Intrinsics  # noqa: E402
from orbslam2_tpu_torch.ops import hamming  # noqa: E402
from orbslam2_tpu_torch.solvers import pose_opt  # noqa: E402


def build(tree: Path, name: str) -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / f"timed_{name}.so"
    csrc = tree / "orbslam2_tpu_torch" / "csrc"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
           str(csrc / "hamming.cu"), str(csrc / "pose_gn.cu")]
    subprocess.run(cmd, capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hamming_distance_matrix.argtypes = [p, p, p, i, i, p]
    lib.hamming_distance_matrix.restype = i
    # an earlier K2 has no num_inliers output
    lib.counts_inliers = hasattr(lib, "pose_gn_max_slots")
    lib.pose_gn.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p, p] + [p] * (1 + lib.counts_inliers)
    lib.pose_gn.restype = i
    return lib


def in_turns(libs: dict, launch) -> dict:
    """Device ms of each library's launch, in the order a, b, b, a."""
    names = list(libs)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(chip_smoke.device_ms(lambda j, lib=libs[k]: launch(lib, j)))
    return times


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    dev = torch.device("cuda")
    print(drive.card_line(), flush=True)
    libs = {"other": build(Path(sys.argv[1]).resolve(), "other"), "this": build(REPO, "this")}
    rng = np.random.default_rng(2)
    for n, m in [(1024, 1024), (1280, 1280), (2525, 1024), (4096, 1024)]:
        a, b = chip_smoke.rand_desc(rng, n, dev), chip_smoke.rand_desc(rng, m, dev)
        want = hamming.distance_matrix(a, b)
        outs = [torch.empty((n, m), dtype=torch.int32, device=dev)
                for _ in range(chip_smoke.copies(4 * n * m))]

        def k1(lib, j):
            kernels.check_launch("hamming", lib.hamming_distance_matrix(
                a.data_ptr(), b.data_ptr(), outs[j % len(outs)].data_ptr(), n, m,
                torch.cuda.current_stream().cuda_stream))

        for name, lib in libs.items():
            k1(lib, 0)
            if not torch.equal(outs[0], want):
                sys.exit(f"K1 of {name} at {n}x{m} differs from the plain version")
        times = in_turns(libs, k1)
        print(f"K1 {n}x{m}: exact; device us, other "
              + " / ".join(f"{1e3 * t:.3f}" for t in times["other"]) + ", this "
              + " / ".join(f"{1e3 * t:.3f}" for t in times["this"]), flush=True)

    K = Intrinsics.from_config(config.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5,
                                                   bf=48.0), dev)
    T0 = torch.eye(4, device=dev)
    for n, n_real, frac in [(1024, 700, 0.6), (1280, 900, 0.0)]:
        obs = chip_smoke.make_pose_problem(np.random.default_rng(1), dev, n=n, n_real=n_real,
                                           stereo_frac=frac)
        ref = pose_opt.pose_optimize(T0, obs, K, 4, 6)
        T = torch.empty((4, 4), device=dev)
        inl = torch.empty(n, dtype=torch.bool, device=dev)
        chi2 = torch.empty(n, device=dev)
        cnt = torch.empty((), dtype=torch.int64, device=dev)

        def k2(lib, _j):
            args = [obs.pw.data_ptr(), obs.uv.data_ptr(), obs.ur.data_ptr(),
                    obs.inv_sigma2.data_ptr(), obs.mask.data_ptr(), K.pinhole.data_ptr(),
                    T0.data_ptr(), n, 4, 6, T.data_ptr(), inl.data_ptr(), chi2.data_ptr()]
            kernels.check_launch("pose_gn", lib.pose_gn(
                *args, *([cnt.data_ptr()] if lib.counts_inliers else []),
                torch.cuda.current_stream().cuda_stream))

        for name, lib in libs.items():
            k2(lib, 0)
            err = float((T - ref.Tcw).abs().max())
            if not (err <= chip_smoke.TOL_K2_TCW and torch.equal(inl, ref.inliers)):
                sys.exit(f"K2 of {name} at N={n} disagrees with the plain version")
        times = in_turns(libs, k2)
        print(f"K2 N={n} ({frac:.0%} stereo), 4x6: device us, other "
              + " / ".join(f"{1e3 * t:.3f}" for t in times["other"]) + ", this "
              + " / ".join(f"{1e3 * t:.3f}" for t in times["this"]), flush=True)


if __name__ == "__main__":
    main()
