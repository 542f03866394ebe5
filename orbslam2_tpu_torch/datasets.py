# A copy of `orbslam2_tpu.io.datasets`, which imports no JAX, kept so that the port imports
# nothing of the reference package; tests/test_torch_no_jax.py holds the
# two equal.
"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

The reference fork has no Examples/ drivers; upstream ORB-SLAM2's drivers
read these three dataset layouts (SURVEY.md §4). Each loader yields frames
as float32 grayscale numpy arrays plus timestamps, matching what
`System.track_*` expects. Image decoding uses PIL (PNG); grayscale
conversion follows the reference's RGB/BGR handling
(reference src/Tracking.cc:179-199).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


def _load_gray(path: str) -> np.ndarray:
    # native C++ decoder (orbslam2_tpu_torch/native/image_io.cc) with PIL fallback
    from orbslam2_tpu_torch.native import decode_image

    arr = decode_image(path)
    if arr is not None:
        return arr.astype(np.float32)
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("L", "I", "I;16", "F"):
        img = img.convert("L")
    return np.asarray(img).astype(np.float32)


def _load_depth_png(path: str, factor: float) -> np.ndarray:
    from orbslam2_tpu_torch.native import decode_image

    arr = decode_image(path)
    if arr is not None:
        return arr / factor
    from PIL import Image

    img = Image.open(path)
    return np.asarray(img).astype(np.float32) / factor


@dataclass
class TumRgbdDataset:
    """TUM RGB-D: rgb/ + depth/ + rgb.txt/depth.txt (+ groundtruth.txt).

    Associates rgb and depth by nearest timestamp within `max_dt` (the
    protocol of TUM's associate.py).
    """

    root: str
    depth_factor: float = 5000.0
    max_dt: float = 0.02

    def __post_init__(self):
        self.rgb_list = self._read_list(os.path.join(self.root, "rgb.txt"))
        self.depth_list = self._read_list(os.path.join(self.root, "depth.txt"))
        self.pairs = self._associate()

    @staticmethod
    def _read_list(path: str) -> list[tuple[float, str]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, name = line.split()[:2]
                out.append((float(t), name))
        return out

    def _associate(self) -> list[tuple[float, str, str]]:
        pairs = []
        j = 0
        d_ts = np.asarray([t for t, _ in self.depth_list])
        for t, rgb in self.rgb_list:
            if not len(d_ts):
                break
            j = int(np.argmin(np.abs(d_ts - t)))
            if abs(d_ts[j] - t) <= self.max_dt:
                pairs.append((t, rgb, self.depth_list[j][1]))
        return pairs

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray, float]:
        t, rgb, depth = self.pairs[i]
        img = _load_gray(os.path.join(self.root, rgb))
        d = _load_depth_png(os.path.join(self.root, depth), self.depth_factor)
        return img, d, t

    def ground_truth(self) -> Optional[tuple[np.ndarray, np.ndarray]]:
        path = os.path.join(self.root, "groundtruth.txt")
        if not os.path.exists(path):
            return None
        from orbslam2_tpu_torch.trajectory import _quat_to_rot_xyzw

        ts, poses = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = [float(x) for x in line.split()]
                Twc = np.eye(4)
                Twc[:3, :3] = _quat_to_rot_xyzw(np.asarray(v[4:8]))
                Twc[:3, 3] = v[1:4]
                ts.append(v[0])
                poses.append(np.linalg.inv(Twc))
        return np.asarray(ts), np.stack(poses)


@dataclass
class KittiOdometryDataset:
    """KITTI odometry: image_0/ image_1/ (grayscale stereo) + times.txt."""

    root: str

    def __post_init__(self):
        with open(os.path.join(self.root, "times.txt")) as f:
            self.times = [float(line) for line in f if line.strip()]
        self.left_dir = os.path.join(self.root, "image_0")
        self.right_dir = os.path.join(self.root, "image_1")
        self.names = sorted(os.listdir(self.left_dir))

    def __len__(self) -> int:
        return min(len(self.times), len(self.names))

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray, float]:
        left = _load_gray(os.path.join(self.left_dir, self.names[i]))
        right = _load_gray(os.path.join(self.right_dir, self.names[i]))
        return left, right, self.times[i]


@dataclass
class EurocDataset:
    """EuRoC MAV: mav0/cam0/data + cam1/data with data.csv timestamps."""

    root: str

    def __post_init__(self):
        self.cam0 = self._read_csv(os.path.join(self.root, "mav0", "cam0"))
        self.cam1 = self._read_csv(os.path.join(self.root, "mav0", "cam1"))
        n = min(len(self.cam0), len(self.cam1))
        self.cam0, self.cam1 = self.cam0[:n], self.cam1[:n]

    @staticmethod
    def _read_csv(cam_dir: str) -> list[tuple[float, str]]:
        out = []
        with open(os.path.join(cam_dir, "data.csv")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, name = line.split(",")[:2]
                out.append((int(ts) * 1e-9, os.path.join(cam_dir, "data", name.strip())))
        return out

    def __len__(self) -> int:
        return len(self.cam0)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray, float]:
        t, left_path = self.cam0[i]
        _, right_path = self.cam1[i]
        return _load_gray(left_path), _load_gray(right_path), t
