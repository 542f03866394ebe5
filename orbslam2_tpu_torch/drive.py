"""What the port's session drivers share (`longrun`, `bench`, `scale` and
`chip_smoke.py`): the synthetic sequences, their frames rendered by worker
processes so that rendering stays out of a timed loop, what a session
record reads (keyframe and event frames), and the device a driver runs
on, named with the card's power limit.

A script that renders through a `RenderPool` with workers needs the
``if __name__ == "__main__":`` guard: the workers are spawned and import
the main module again.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import subprocess

import numpy as np
import torch

from orbslam2_tpu_torch import synthetic

# render workers (numpy on one core each, about a second for a 640x480
# frame and a quarter of that at 320x240)
RENDER_WORKERS = min(8, os.cpu_count() or 1)
# one BLAS thread a worker: eight renderers with a full BLAS pool each ran
# no faster than one process
_ONE_THREAD = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
_SEQS: dict = {}


def yawed_poses(base, yaws) -> np.ndarray:
    """`base` turned about the camera's y axis by each of `yaws` degrees."""
    out = []
    for yaw in yaws:
        a = np.radians(yaw)
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        out.append(T @ base)
    return np.stack(out)


def sequence(spec):
    """The synthetic sequence of `spec` = (n_frames, kind, camera, more) or
    (n_frames, kind, camera, more, yaws): the `n_frames` poses of `kind`
    followed by `more` frames that repeat them from the start (the orbits'
    revisits, the long run's further revolutions); with `yaws`, the poses
    are instead the last frame's turned by each of them (localization
    mode). Frame i's noise is seeded by i, so repeated poses give new
    frames. Made once per process."""
    if spec not in _SEQS:
        n_frames, kind, cam, more, *turn = spec
        seq = synthetic.textured_sequence(n_frames=n_frames, kind=kind, seed=0, cam=cam)
        if more:
            reps = -(-(n_frames + more) // n_frames)
            poses = np.concatenate([seq.poses] * reps)[:n_frames + more]
            seq = dataclasses.replace(seq, poses=poses)
        if turn:
            seq = dataclasses.replace(seq, poses=yawed_poses(seq.poses[-1], turn[0]))
        _SEQS[spec] = seq
    return _SEQS[spec]


def _render(task):
    spec, i, stereo = task
    seq = sequence(spec)
    return seq.stereo(i)[:2] if stereo else seq.frame(i)


class RenderPool:
    """Worker processes that render frames of `sequence(spec)`: spawned,
    not forked (the caller may hold a CUDA context), one BLAS thread each.
    `workers` defaults to RENDER_WORKERS; with 0 the frames render in this
    process."""

    def __init__(self, workers: int | None = None):
        self._pool = None
        workers = RENDER_WORKERS if workers is None else workers
        if workers > 0:
            saved = {k: os.environ.get(k) for k in _ONE_THREAD}
            os.environ.update(_ONE_THREAD)
            try:
                self._pool = multiprocessing.get_context("spawn").Pool(workers)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k)
                    else:
                        os.environ[k] = v

    def render(self, spec, indices, stereo: bool = False) -> list:
        """Frames `indices` of `sequence(spec)`: (image, depth) each, or
        (left, right) with `stereo`."""
        tasks = [(spec, i, stereo) for i in indices]
        if self._pool is None:
            return [_render(t) for t in tasks]
        return self._pool.map(_render, tasks)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self) -> "RenderPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def keyframe_frames(slam) -> list[int]:
    """The frames of a session that became keyframes."""
    return [i for i, r in enumerate(slam.results) if r.is_keyframe]


def frame_events(slam, kind: str) -> list[int]:
    """The frame (0-based) during which each event of `kind` was emitted;
    events of a final flush get the frame count."""
    n, out = 0, []
    for e in slam.log.events:
        if e["event"] == "frame":
            n += 1
        elif e["event"] == kind:
            out.append(n)
    return out


def require_device(name: str) -> torch.device:
    """The device a driver runs on: `cuda` unless the caller asks for
    `cpu`; `cuda` without a CUDA device raises rather than fall back."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` for
    the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_fields(device: torch.device) -> dict:
    """`device` (the card's name, or "cpu") and `power_limit` (the card's,
    as nvidia-smi reports it; None on the CPU) for a driver's JSON line."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": card_line().split(",")[-1].strip()}


def peak_device_bytes(device: torch.device):
    """`torch.cuda.max_memory_allocated` on a card, None on the CPU."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
