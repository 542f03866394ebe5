# A copy of `orbslam2_tpu.io.synthetic`, which imports no JAX, kept so that the port imports
# nothing of the reference package; tests/test_torch_no_jax.py holds the
# two equal.
"""Synthetic SLAM sequences with exact ground truth.

The reference fork ships no datasets or tests; its de-facto harness is
TUM/KITTI sequences (SURVEY.md §4). This container has no datasets either,
so we render our own: a random 3D "starfield" of high-contrast textured
blobs, a parameterized camera trajectory, and pinhole projection with
z-buffering — giving pixel-accurate ground-truth poses and depth for every
frame. Pure numpy (host-side fixture generation, not a hot path).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from orbslam2_tpu_torch.config import CameraConfig


@dataclasses.dataclass
class SyntheticWorld:
    points: np.ndarray       # [P, 3] world coords
    intensity: np.ndarray    # [P] blob peak intensity
    pattern: np.ndarray      # [P, S, S] per-point texture stamp
    background: float = 18.0


def make_world(
    n_points: int = 3000,
    extent: tuple[float, float, float] = (14.0, 10.0, 10.0),
    z_offset: float = 2.0,
    stamp: int = 7,
    seed: int = 0,
) -> SyntheticWorld:
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, size=(n_points, 3)) * np.asarray(extent)
    pts[:, 2] += z_offset + extent[2] / 2.0
    intensity = rng.uniform(80.0, 255.0, size=n_points)
    # distinctive per-point stamps so descriptors are discriminative
    pattern = rng.uniform(0.35, 1.0, size=(n_points, stamp, stamp))
    pattern *= (rng.uniform(0, 1, size=(n_points, stamp, stamp)) > 0.35)
    mid = stamp // 2
    pattern[:, mid, mid] = 1.0
    return SyntheticWorld(points=pts, intensity=intensity, pattern=pattern)


def _bilinear_shift(stamps: np.ndarray, fv: np.ndarray, fu: np.ndarray) -> np.ndarray:
    """Shift each stamp [P, S, S] by its fractional (fv, fu) in [-0.5, 0.5]
    via bilinear resampling (vectorized over all stamps)."""
    P, S, _ = stamps.shape
    if P == 0:
        return stamps
    padded = np.pad(stamps, ((0, 0), (1, 1), (1, 1)))
    gy = 1.0 - fv  # sample row offset for output row y: y + gy
    gx = 1.0 - fu
    oy = np.floor(gy).astype(np.int64)
    ox = np.floor(gx).astype(np.int64)
    wy = (gy - oy)[:, None, None]
    wx = (gx - ox)[:, None, None]
    Y, X = np.mgrid[0:S, 0:S]
    pi = np.arange(P)[:, None, None]
    out = np.zeros_like(stamps)
    for dy, wgy in ((0, 1.0 - wy), (1, wy)):
        for dx, wgx in ((0, 1.0 - wx), (1, wx)):
            out += wgy * wgx * padded[pi, Y + oy[:, None, None] + dy, X + ox[:, None, None] + dx]
    return out


def _resize_stamps(stamps: np.ndarray, size: int) -> np.ndarray:
    """Bilinear-resize [N, S, S] -> [N, size, size] (vectorized)."""
    N, S, _ = stamps.shape
    if size == S:
        return stamps
    g = (np.arange(size) + 0.5) * S / size - 0.5
    g = np.clip(g, 0, S - 1)
    i0 = np.floor(g).astype(np.int64)
    i1 = np.minimum(i0 + 1, S - 1)
    w = (g - i0)[None, :]
    rows = stamps[:, i0, :] * (1 - w[..., None]) + stamps[:, i1, :] * w[..., None]
    out = rows[:, :, i0] * (1 - w[:, None, :]) + rows[:, :, i1] * w[:, None, :]
    return out


def render_frame(
    world: SyntheticWorld,
    Tcw: np.ndarray,
    cam: CameraConfig,
    noise: float = 0.0,
    seed: int = 0,
    blob_size_m: float = 0.08,
) -> tuple[np.ndarray, np.ndarray]:
    """Render (image [H, W] float32, depth [H, W] float32; 0 = no depth).

    Z-buffered, PERSPECTIVE-CORRECT stamp splatting: each point is a flat
    blob of physical size `blob_size_m`, so its pixel footprint scales with
    f/z. (Constant-pixel-size stamps would make detected blob corners carry
    a fixed pixel offset while the backprojected 3-D corner's projection
    scales with 1/z — a systematic radial bias that corrupts pose
    optimization during dolly motion.) Sub-pixel placement via bilinear
    shifting keeps disparity/flow truth below 0.1 px.
    """
    H, W = cam.height, cam.width
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = world.points @ R.T + t
    z = pc[:, 2]
    vis = z > 0.3
    u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
    v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
    # per-point pixel size (odd, 3..31)
    # clipping the pixel size would silently break perspective scaling (a
    # fixed-pixel-size blob biases pose estimation during dolly motion), so
    # keep the world's depth range and blob size inside the representable band
    px = cam.fx * blob_size_m / np.maximum(z, 1e-6)
    sizes = np.clip((np.round((px - 1) / 2) * 2 + 1).astype(np.int64), 3, 63)
    iu_all = np.round(u).astype(np.int64)
    iv_all = np.round(v).astype(np.int64)
    half_all = sizes // 2
    vis &= (
        (iu_all >= half_all) & (iu_all < W - half_all)
        & (iv_all >= half_all) & (iv_all < H - half_all)
    )

    image = np.full((H, W), world.background, np.float32)
    depth = np.zeros((H, W), np.float32)

    idx = np.nonzero(vis)[0]
    idx = idx[np.argsort(-z[idx])]  # far to near: near overwrites
    iu, iv = iu_all, iv_all
    # group by stamp size for vectorized resize+shift
    order_in_draw = {i: n for n, i in enumerate(idx)}
    stamps_shifted: dict[int, np.ndarray] = {}
    group_pos: dict[int, dict[int, int]] = {}
    for s in np.unique(sizes[idx]):
        sel = idx[sizes[idx] == s]
        resized = _resize_stamps(world.pattern[sel], int(s))
        shifted = _bilinear_shift(resized, (v[sel] - iv[sel]), (u[sel] - iu[sel]))
        stamps_shifted[int(s)] = shifted
        group_pos[int(s)] = {int(i): n for n, i in enumerate(sel)}
    for i in idx:
        s = int(sizes[i])
        half = s // 2
        stamp = stamps_shifted[s][group_pos[s][int(i)]] * world.intensity[i]
        y0, x0 = iv[i] - half, iu[i] - half
        region = image[y0 : y0 + s, x0 : x0 + s]
        np.maximum(region, stamp, out=region)
        mask = stamps_shifted[s][group_pos[s][int(i)]] > 0.01
        depth[y0 : y0 + s, x0 : x0 + s][mask] = z[i]

    if noise > 0:
        rng = np.random.default_rng(seed)
        image = image + rng.normal(0, noise, size=image.shape)
    return np.clip(image, 0, 255).astype(np.float32), depth


def stereo_pair(
    world: SyntheticWorld, Tcw: np.ndarray, cam: CameraConfig, **kw
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left image, right image, left depth) for a rectified pair with
    baseline bf/fx along +x."""
    left, depth = render_frame(world, Tcw, cam, **kw)
    T_rl = np.eye(4)
    T_rl[0, 3] = -cam.baseline  # right camera is +x of left => point shifts -x
    right, _ = render_frame(world, T_rl @ Tcw, cam, **kw)
    return left, right, depth


# ---------------------------------------------------------------------------
# Photometric-realistic textured world (ray-cast planes + boxes)
# ---------------------------------------------------------------------------
#
# The starfield above is adversarial in ways real imagery is not: isolated
# near-identical blobs (weak descriptor discrimination) on a flat background
# (depth defined only ON the blobs -> ~40 % of keypoints get no RGB-D depth).
# Real TUM/KITTI-class scenes are textured surfaces with dense depth. This
# renderer ray-casts a closed textured room — floor/ceiling/walls plus
# occluding boxes — with multi-octave value-noise textures anchored to each
# surface (viewpoint-consistent, mip-faded near Nyquist), exact per-pixel
# depth, and optional exposure drift + sensor noise.


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


def _vnoise(a: np.ndarray, b: np.ndarray, seed: float) -> np.ndarray:
    """Smoothstep-interpolated value noise on a unit lattice, in [0, 1)."""
    ia = np.floor(a)
    ib = np.floor(b)
    fa = a - ia
    fb = b - ib
    fa = fa * fa * (3.0 - 2.0 * fa)
    fb = fb * fb * (3.0 - 2.0 * fb)

    def h(i, j):
        x = np.sin(i * 127.1 + j * 311.7 + seed * 74.7) * 43758.5453
        return x - np.floor(x)

    v00 = h(ia, ib)
    v10 = h(ia + 1.0, ib)
    v01 = h(ia, ib + 1.0)
    v11 = h(ia + 1.0, ib + 1.0)
    return (
        v00 * (1 - fa) * (1 - fb)
        + v10 * fa * (1 - fb)
        + v01 * (1 - fa) * fb
        + v11 * fa * fb
    )


_OCTAVES = (
    (0.9, 0.24), (0.37, 0.20), (0.15, 0.19), (0.055, 0.16),
    # sub-2cm octaves give close-range (1-4 m) surfaces FAST-detectable
    # micro-texture; the per-pixel mip fade removes them at distance
    (0.02, 0.12), (0.0075, 0.09),
)


def _texture(a, b, seed: float, footprint: np.ndarray) -> np.ndarray:
    """Multi-octave surface texture in [0, 1]. Octaves whose wavelength
    approaches the pixel footprint are faded out (mip filtering) so the
    appearance stays consistent across viewing distance."""
    total = np.zeros_like(a)
    wsum = np.zeros_like(a)
    for wl, w in _OCTAVES:
        # full weight once the wavelength spans >= 4 px, zero below 2 px
        px_per_wl = wl / np.maximum(footprint, 1e-6)
        fade = np.clip((px_per_wl - 2.0) / 2.0, 0.0, 1.0)
        total += (w * fade) * _vnoise(a / wl, b / wl, seed + wl * 17.0)
        wsum += w * fade
    return total / np.maximum(wsum, 1e-6)


def render_textured(
    world: TexturedWorld,
    Tcw: np.ndarray,
    cam: CameraConfig,
    noise: float = 1.0,
    seed: int = 0,
    exposure: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Ray-cast (image [H, W] float32 0..255, depth [H, W] float32 meters).

    Depth is the camera-frame z of the first hit (0 where no surface —
    does not happen inside the closed room). Rays are parameterized so the
    ray parameter IS the camera-frame depth: dir_cam = ((u-cx)/fx,
    (v-cy)/fy, 1)."""
    H, W = cam.height, cam.width
    Twc = np.linalg.inv(Tcw)
    Rwc, C = Twc[:3, :3], Twc[:3, 3]
    us, vs = np.meshgrid(
        np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64)
    )
    dir_cam = np.stack(
        [(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy, np.ones_like(us)], -1
    ).reshape(-1, 3)
    dirs_w = dir_cam @ Rwc.T

    best_t = np.full(H * W, np.inf)
    img = np.zeros(H * W)
    for q in world.quads:
        n = np.cross(q.eu, q.ev)
        denom = dirs_w @ n
        tnum = float((q.origin - C) @ n)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = tnum / denom
        hit = np.isfinite(t) & (t > 0.05) & (t < best_t)
        if not hit.any():
            continue
        p = C + t[hit, None] * dirs_w[hit]
        d = p - q.origin
        lu2 = float(q.eu @ q.eu)
        lv2 = float(q.ev @ q.ev)
        a = (d @ q.eu) / lu2
        b = (d @ q.ev) / lv2
        on = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
        if not on.any():
            continue
        idx = np.nonzero(hit)[0][on]
        tq = t[idx]
        foot = tq / cam.fx  # meters per pixel at that depth (fronto approx)
        val = _texture(
            a[on] * np.sqrt(lu2), b[on] * np.sqrt(lv2), q.seed, foot
        )
        img[idx] = (22.0 + 212.0 * val) * q.base
        best_t[idx] = tq

    depth = np.where(np.isfinite(best_t), best_t, 0.0).reshape(H, W)
    image = img.reshape(H, W) * exposure
    if noise > 0:
        rng = np.random.default_rng(seed)
        image = image + rng.normal(0.0, noise, size=image.shape)
    return (
        np.clip(image, 0.0, 255.0).astype(np.float32),
        depth.astype(np.float32),
    )


@dataclasses.dataclass
class TexturedSequence:
    """RGB-D / stereo / mono sequence over the ray-cast textured room."""

    world: TexturedWorld
    poses: np.ndarray          # [N, 4, 4] ground-truth Tcw
    cam: CameraConfig
    noise: float = 1.0
    exposure_drift: float = 0.0   # peak fractional gain drift over the run

    def __len__(self) -> int:
        return len(self.poses)

    def _exposure(self, i: int) -> float:
        if self.exposure_drift == 0.0:
            return 1.0
        return 1.0 + self.exposure_drift * np.sin(2.0 * np.pi * i / max(len(self), 1))

    def frame(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return render_textured(
            self.world, self.poses[i], self.cam, noise=self.noise, seed=i,
            exposure=self._exposure(i),
        )

    def stereo(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        left, depth = self.frame(i)
        T_rl = np.eye(4)
        T_rl[0, 3] = -self.cam.baseline
        right, _ = render_textured(
            self.world, T_rl @ self.poses[i], self.cam, noise=self.noise,
            seed=i + 50000, exposure=self._exposure(i),
        )
        return left, right, depth

    def timestamps(self) -> np.ndarray:
        return np.arange(len(self.poses), dtype=np.float64) / self.cam.fps


def textured_sequence(
    n_frames: int = 60,
    kind: str = "forward",
    seed: int = 0,
    cam: Optional[CameraConfig] = None,
    noise: float = 1.0,
    exposure_drift: float = 0.0,
    room_kw: Optional[dict] = None,
) -> TexturedSequence:
    """Photometric-realism sequence: textured room + occluders + optional
    exposure drift (what VERDICT round 1 asked the starfield to become).

    `kind="orbit"` circles the room center looking inward — opposite
    sides of the orbit see disjoint structure, so covisibility genuinely
    breaks and the return leg is a true loop-closure event (the corridor
    out-and-back never disconnects covisibility)."""
    cam = cam or CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
    if kind == "forward":
        world = make_room(seed=seed, **(room_kw or {}))
        poses = forward_trajectory(n_frames)
    elif kind == "lateral":
        world = make_room(seed=seed, **(room_kw or {}))
        poses = lateral_trajectory(n_frames, step=0.035)
    elif kind == "orbit":
        # central box cluster (inside the orbit) occludes the far side, so
        # opposite orbit positions see disjoint structure; the r=4 path
        # keeps >= 2.3 m clearance from the cluster so optical flow stays
        # trackable at ~2 deg/frame
        kw = dict(
            width=12.0, length=18.0, n_boxes=8,
            box_region=(-1.2, 1.2, 7.8, 10.2),
        )
        kw.update(room_kw or {})
        world = make_room(seed=seed, **kw)
        poses = orbit_trajectory(n_frames, radius=4.0, center_z=9.0)
    elif kind == "outback":
        world = make_room(seed=seed, **(room_kw or {}))
        poses = outback_trajectory(n_frames)
    else:
        raise ValueError(kind)
    return TexturedSequence(
        world=world, poses=poses, cam=cam, noise=noise,
        exposure_drift=exposure_drift,
    )


def forward_trajectory(
    n_frames: int,
    step: float = 0.06,
    yaw_rate: float = 0.002,
    sway: float = 0.01,
) -> np.ndarray:
    """[N, 4, 4] ground-truth Tcw: mostly-forward dolly with gentle yaw/sway."""
    poses = []
    Twc = np.eye(4)
    for i in range(n_frames):
        poses.append(np.linalg.inv(Twc))
        c, s = np.cos(yaw_rate), np.sin(yaw_rate)
        dR = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Twc = Twc @ _make_se3(dR, [sway * np.sin(i * 0.2), sway * 0.5 * np.cos(i * 0.13), step])
    return np.stack(poses)


def lateral_trajectory(
    n_frames: int,
    step: float = 0.05,
    yaw_rate: float = 0.0015,
) -> np.ndarray:
    """[N, 4, 4] Tcw: sideways dolly (good parallax for monocular init)."""
    poses = []
    Twc = np.eye(4)
    for i in range(n_frames):
        poses.append(np.linalg.inv(Twc))
        c, s = np.cos(yaw_rate), np.sin(yaw_rate)
        dR = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Twc = Twc @ _make_se3(dR, [step, 0.005 * np.sin(i * 0.3), 0.01])
    return np.stack(poses)


def outback_trajectory(n_frames: int, step: float = 0.06, yaw_rate: float = 0.002) -> np.ndarray:
    """[N, 4, 4] Tcw: dolly out for half the frames, then retrace the same
    path back — guaranteed revisits for loop closure / relocalization."""
    half = forward_trajectory(n_frames // 2 + 1, step=step, yaw_rate=yaw_rate)
    back = half[::-1][1:]
    full = np.concatenate([half, back])[:n_frames]
    return full


def orbit_trajectory(n_frames: int, radius: float = 4.0, center_z: float = 12.0) -> np.ndarray:
    """[N, 4, 4] Tcw orbiting the world center, always looking at it —
    exercises loop closure (comes back to the start)."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / n_frames
        eye = np.asarray([radius * np.sin(a), 0.0, center_z - radius * np.cos(a)])
        target = np.asarray([0.0, 0.0, center_z])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.asarray([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        dn = np.cross(fwd, right)
        Rwc = np.stack([right, dn, fwd], axis=1)
        Twc = _make_se3(Rwc, eye)
        poses.append(np.linalg.inv(Twc))
    return np.stack(poses)


def _make_se3(R, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


@dataclasses.dataclass
class SyntheticSequence:
    """An iterable RGB-D / stereo / mono sequence with ground truth."""

    world: SyntheticWorld
    poses: np.ndarray  # [N, 4, 4] ground-truth Tcw
    cam: CameraConfig
    # NOTE: additive sensor noise makes BRIEF pairs sampled on the flat
    # background compare randomly (descriptor Hamming ~55 between identical
    # views). Real scenes are textured everywhere; default to noiseless
    # until the renderer grows a textured backplane.
    noise: float = 0.0

    def __len__(self) -> int:
        return len(self.poses)

    def frame(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return render_frame(self.world, self.poses[i], self.cam, noise=self.noise, seed=i)

    def stereo(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return stereo_pair(self.world, self.poses[i], self.cam, noise=self.noise, seed=i)

    def timestamps(self) -> np.ndarray:
        return np.arange(len(self.poses), dtype=np.float64) / self.cam.fps


def default_sequence(
    n_frames: int = 60,
    kind: str = "forward",
    n_points: int = 3000,
    seed: int = 0,
    cam: Optional[CameraConfig] = None,
) -> SyntheticSequence:
    cam = cam or CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
    world = make_world(n_points=n_points, seed=seed)
    if kind == "forward":
        poses = forward_trajectory(n_frames)
    elif kind == "lateral":
        poses = lateral_trajectory(n_frames)
    elif kind == "orbit":
        poses = orbit_trajectory(n_frames)
    elif kind == "outback":
        poses = outback_trajectory(n_frames)
    else:
        raise ValueError(kind)
    return SyntheticSequence(world=world, poses=poses, cam=cam)
