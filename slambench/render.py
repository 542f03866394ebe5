"""The benchmark's frames: a frozen copy of the port's textured room,
ray-cast on the card, along a trajectory drawn from the traffic mix.

`make_room` (a closed corridor with textured boxes) and the texture
(multi-octave value noise with a per-pixel mip fade) are copied from
`orbslam2_tpu_torch/synthetic.py`, so that a change to the program cannot
change the benchmark's inputs; `render_batch` is the same ray cast written
for a batch of poses in float64 torch, so a whole session renders on the
card in seconds. `test_slambench_harness.py` holds it to the program's
renderer at one small size.

`sweep_trajectory` is a survey flown out and back along the corridor at
a constant speed, the camera panning left and right: speed, angular rate
and length are the mix's, taken from a dataset's published sequence
table. `session_frames` renders a session and hands back what a dataset
stores: 8-bit intensities with sensor noise drawn from the room, and for
RGB-D depth in 16 bits of 1/5000 m (0 = no reading, as a Kinect gives
beyond its range); for stereo the true depth is kept for the reference.
Every seed is handed the same frames.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

# TUM RGB-D stores depth as 16-bit PNGs in units of 1/5000 m
TUM_DEPTH_UNITS = 5000.0
# the reference's true depth is kept in units of 1/2000 m (32 m range)
TRUTH_UNITS = 2000.0
# poses rendered in one batch of device calls
BATCH = 4


@dataclasses.dataclass(frozen=True)
class Camera:
    """A rectified pinhole camera: intrinsics, image size and bf."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    bf: float

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


@dataclasses.dataclass
class Quad:
    """One textured rectangle: origin corner + two edge vectors (meters)."""

    origin: np.ndarray   # [3]
    eu: np.ndarray       # [3] full edge along local u
    ev: np.ndarray       # [3] full edge along local v
    seed: float          # texture seed
    base: float = 1.0    # brightness multiplier


@dataclasses.dataclass
class TexturedWorld:
    quads: list


def make_room(
    seed: int = 0,
    length: float = 18.0,
    width: float = 4.5,
    height: float = 2.6,
    n_boxes: int = 6,
    back: float = 3.0,
    box_region: Optional[tuple] = None,   # (xmin, xmax, zmin, zmax)
) -> TexturedWorld:
    """Closed corridor room. Camera starts at the origin looking +z
    (x right, y down): floor at y=+height/2, ceiling at y=-height/2, side
    walls at x=+-width/2, far wall at z=length, near wall at z=-back."""
    rng = np.random.default_rng(seed)
    hw, hh = width / 2.0, height / 2.0
    A = np.asarray
    quads = [
        # floor: u along x, v along z
        Quad(A([-hw, hh, -back]), A([width, 0, 0]), A([0, 0, length + back]), 11.0),
        # ceiling
        Quad(A([-hw, -hh, -back]), A([width, 0, 0]), A([0, 0, length + back]), 23.0, 0.9),
        # left wall (x=-hw): u along z, v along y
        Quad(A([-hw, -hh, -back]), A([0, 0, length + back]), A([0, height, 0]), 37.0),
        # right wall
        Quad(A([hw, -hh, -back]), A([0, 0, length + back]), A([0, height, 0]), 41.0),
        # far wall: u along x, v along y
        Quad(A([-hw, -hh, length]), A([width, 0, 0]), A([0, height, 0]), 53.0),
        # near wall (behind the start, for orbit/backward views)
        Quad(A([-hw, -hh, -back]), A([width, 0, 0]), A([0, height, 0]), 67.0, 0.85),
    ]
    for b in range(n_boxes):
        sx = rng.uniform(0.4, 0.9)
        sy = rng.uniform(0.6, 1.6)
        sz = rng.uniform(0.4, 0.9)
        if box_region is not None:
            x0_, x1_, z0_, z1_ = box_region
            cx = rng.uniform(x0_, x1_)
            cz = z0_ + (z1_ - z0_) * (b + rng.uniform(0.0, 0.8)) / n_boxes
        else:
            cx = rng.uniform(-hw + 0.7, hw - 0.7)
            cz = 1.5 + (length - 4.0) * (b + rng.uniform(0.0, 0.8)) / n_boxes
        x0, z0 = cx - sx / 2.0, cz - sz / 2.0
        y0 = hh - sy          # sits on the floor, extends up (-y)
        s = 100.0 + 13.0 * b
        quads += [
            # top face
            Quad(A([x0, y0, z0]), A([sx, 0, 0]), A([0, 0, sz]), s + 1),
            # front face (toward camera, -z normal)
            Quad(A([x0, y0, z0]), A([sx, 0, 0]), A([0, sy, 0]), s + 2),
            # back face
            Quad(A([x0, y0, z0 + sz]), A([sx, 0, 0]), A([0, sy, 0]), s + 3),
            # left face
            Quad(A([x0, y0, z0]), A([0, 0, sz]), A([0, sy, 0]), s + 4),
            # right face
            Quad(A([x0 + sx, y0, z0]), A([0, 0, sz]), A([0, sy, 0]), s + 5),
        ]
    return TexturedWorld(quads=quads)



_OCTAVES = (
    (0.9, 0.24), (0.37, 0.20), (0.15, 0.19), (0.055, 0.16),
    # sub-2cm octaves give close-range (1-4 m) surfaces FAST-detectable
    # micro-texture; the per-pixel mip fade removes them at distance
    (0.02, 0.12), (0.0075, 0.09),
)


def _vnoise(a: torch.Tensor, b: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Smoothstep-interpolated value noise on a unit lattice, in [0, 1)."""
    ia, ib = torch.floor(a), torch.floor(b)
    fa, fb = a - ia, b - ib
    fa = fa * fa * (3.0 - 2.0 * fa)
    fb = fb * fb * (3.0 - 2.0 * fb)

    def h(i, j):
        x = torch.sin(i * 127.1 + j * 311.7 + seed * 74.7) * 43758.5453
        return x - torch.floor(x)

    return (h(ia, ib) * (1 - fa) * (1 - fb) + h(ia + 1.0, ib) * fa * (1 - fb)
            + h(ia, ib + 1.0) * (1 - fa) * fb + h(ia + 1.0, ib + 1.0) * fa * fb)


def _texture(a, b, seed, footprint) -> torch.Tensor:
    """Multi-octave surface texture in [0, 1]; octaves whose wavelength
    nears the pixel footprint fade out (full weight at >= 4 px, none
    below 2 px)."""
    total = torch.zeros_like(a)
    wsum = torch.zeros_like(a)
    for wl, w in _OCTAVES:
        fade = torch.clamp((wl / torch.clamp(footprint, min=1e-6) - 2.0) / 2.0, 0.0, 1.0)
        total = total + (w * fade) * _vnoise(a / wl, b / wl, seed + wl * 17.0)
        wsum = wsum + w * fade
    return total / torch.clamp(wsum, min=1e-6)


def render_batch(world: TexturedWorld, Tcw: torch.Tensor, cam: Camera) -> tuple:
    """Ray-cast a batch of poses `Tcw` [B, 4, 4] (float64, on the device
    to render on): (image [B, H, W] float64 0..255, noiseless; depth
    [B, H, W] float64 m, the camera-frame z of the first hit). Each ray
    takes the nearest quad it hits beyond 0.05 m (the first in the room's
    order on a tie), as the program's renderer does."""
    dev, f64 = Tcw.device, torch.float64
    B, H, W = Tcw.shape[0], cam.height, cam.width
    Twc = torch.linalg.inv(Tcw)
    Rwc, C = Twc[:, :3, :3], Twc[:, :3, 3]
    vs, us = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev), indexing="ij")
    dir_cam = torch.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                           torch.ones_like(us)], -1).reshape(-1, 3)
    dirs = torch.einsum("pk,bjk->bpj", dir_cam, Rwc)              # [B, P, 3]
    q_origin = torch.tensor(np.stack([q.origin for q in world.quads]), dtype=f64, device=dev)
    q_eu = torch.tensor(np.stack([q.eu for q in world.quads]), dtype=f64, device=dev)
    q_ev = torch.tensor(np.stack([q.ev for q in world.quads]), dtype=f64, device=dev)
    # every quad against every ray at once: t along the ray, and the hit's
    # place (a, b) on the quad's two edges
    n = torch.linalg.cross(q_eu, q_ev)                              # [Q, 3]
    proj = dirs @ torch.cat([n, q_eu, q_ev]).T                      # [B, P, 3Q]
    Q = len(world.quads)
    dn, de, dv = proj[..., :Q], proj[..., Q:2 * Q], proj[..., 2 * Q:]
    rel = C[:, None, :] - q_origin[None]                            # [B, Q, 3]
    t = -(rel * n).sum(-1)[:, None, :] / dn
    a = ((rel * q_eu).sum(-1)[:, None, :] + t * de) / (q_eu * q_eu).sum(-1)
    b = ((rel * q_ev).sum(-1)[:, None, :] + t * dv) / (q_ev * q_ev).sum(-1)
    on = (torch.isfinite(t) & (t > 0.05) & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0))
    t = torch.where(on, t, math.inf)
    del proj, dn, de, dv, a, b, on
    # the nearest quad, the first in the room's order on a tie
    best_t, best_q = torch.min(t, dim=-1)
    best_q = torch.where(torch.isfinite(best_t), best_q, -1)
    del t
    # the texture of each ray's quad, evaluated once
    qi = best_q.clamp(min=0)
    o, eu, ev = q_origin[qi], q_eu[qi], q_ev[qi]
    lu2, lv2 = (eu * eu).sum(-1), (ev * ev).sum(-1)
    t = torch.where(best_q >= 0, best_t, torch.zeros_like(best_t))
    d = C[:, None, :] + t[..., None] * dirs - o
    a = (d * eu).sum(-1) / lu2
    b = (d * ev).sum(-1) / lv2
    seeds = torch.tensor([q.seed for q in world.quads], dtype=f64, device=dev)[qi]
    base = torch.tensor([q.base for q in world.quads], dtype=f64, device=dev)[qi]
    val = _texture(a * torch.sqrt(lu2), b * torch.sqrt(lv2), seeds, t / cam.fx)
    img = torch.where(best_q >= 0, (22.0 + 212.0 * val) * base, torch.zeros_like(val))
    depth = torch.where(best_q >= 0, best_t, torch.zeros_like(best_t))
    return img.reshape(B, H, W), depth.reshape(B, H, W)


def _se3(yaw: float, t) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T[:3, 3] = t
    return T


def sweep_trajectory(n_frames: int, fps: float, speed_m_s: float, leg_m: float,
                     pan_deg_s: float, pan_amplitude_deg: float) -> np.ndarray:
    """[N, 4, 4] Tcw: the camera flies along the corridor's axis at
    `speed_m_s`, out for `leg_m` and back, again and again, facing down
    the corridor while it pans (yaw) as a sine of `pan_amplitude_deg`
    whose mean angular rate is `pan_deg_s`. Frame 0 is the identity, so
    a session's world frame is the ground truth's."""
    amp = math.radians(pan_amplitude_deg)
    period = 4.0 * pan_amplitude_deg / pan_deg_s if pan_deg_s > 0 else math.inf
    out = []
    for i in range(n_frames):
        t = i / fps
        u = math.fmod(speed_m_s * t, 2.0 * leg_m)
        z = u if u <= leg_m else 2.0 * leg_m - u
        yaw = amp * math.sin(2.0 * math.pi * t / period)
        out.append(np.linalg.inv(_se3(yaw, [0.0, 0.0, z])))
    return np.stack(out)


def trajectory(mix: dict, fps: float) -> np.ndarray:
    """The ground-truth Tcw of every frame of the mix's session."""
    p = mix["path"]
    if p["kind"] != "sweep":
        raise ValueError(f"unknown path kind {p['kind']!r}")
    return sweep_trajectory(int(mix["session_frames"]), fps, float(p["speed_m_s"]),
                            float(p["leg_m"]), float(p["pan_deg_s"]),
                            float(p["pan_amplitude_deg"]))


def _fixed(x: torch.Tensor, units: float) -> torch.Tensor:
    """16-bit fixed point in 1/`units` m; 0 where out of range (a depth
    beyond the sensor's 16 bits reads as no depth)."""
    q = torch.round(x * units)
    return torch.where((q >= 0) & (q <= 65535), q, torch.zeros_like(q)).to(torch.int32)


def session_frames(world: TexturedWorld, Tcw: np.ndarray, cam: Camera, stereo: bool,
                   noise: float, noise_seed: int, device,
                   batch: int = BATCH) -> dict:
    """Every frame of a session as the dataset stores it, on the host:
    "left" uint8 [N, H, W] (and "right" for stereo), and "depth" uint16
    [N, H, W]: for RGB-D what the program is handed (1/5000 m), for
    stereo the reference's truth (1/2000 m). The noise is drawn on the
    device from one generator seeded with `noise_seed`, batch by batch in
    frame order."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(noise_seed))
    T_rl = np.eye(4)
    T_rl[0, 3] = -cam.baseline
    units = TRUTH_UNITS if stereo else TUM_DEPTH_UNITS
    left, right, depth = [], [], []

    def sensor(img):
        x = img + noise * torch.randn(img.shape, generator=gen, dtype=torch.float64, device=dev)
        return torch.clamp(torch.round(x), 0, 255).to(torch.uint8).cpu().numpy()

    for s in range(0, len(Tcw), batch):
        T = torch.tensor(Tcw[s:s + batch], dtype=torch.float64, device=dev)
        img, dep = render_batch(world, T, cam)
        left.append(sensor(img))
        depth.append(_fixed(dep, units).cpu().numpy().astype(np.uint16))
        if stereo:
            r, _ = render_batch(world, torch.tensor(T_rl, dtype=torch.float64, device=dev) @ T, cam)
            right.append(sensor(r))
    out = {"left": np.concatenate(left), "depth": np.concatenate(depth)}
    if stereo:
        out["right"] = np.concatenate(right)
    return out


def decode_depth(depth16: np.ndarray, units: float = TUM_DEPTH_UNITS) -> np.ndarray:
    """16-bit depth in 1/`units` m to float32 metres (0 = no depth), as a
    TUM reader decodes it."""
    return depth16.astype(np.float32) / np.float32(units)
