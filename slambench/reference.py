"""The plain reference that decides `correct`: NumPy only, independent of
the program (it imports nothing of it and takes no table it made).

What the program derived from the benchmark's inputs is worked out again
here, from the same inputs, and compared:

* frame build: whether each of the program's keypoints is a FAST-9
  corner at the low threshold that tops its 3x3 neighbourhood, at its
  pixel of its pyramid level; the ORB descriptor of each keypoint
  (its pyramid level, the intensity-centroid angle, the steered BRIEF
  test over the Gaussian-blurred level, with the 256 pairs drawn as
  ORB-SLAM2's port defines them: seed 7, N(0, (31/5)^2) clipped to a disk
  of radius 12.5); for RGB-D the depth each keypoint reads from the depth
  map (ORB-SLAM2 Frame::ComputeStereoFromRGBD, with the port's 3x3
  discontinuity veto); for stereo the matched disparity against the
  rendered scene's true depth;
* tracking: each frame's pose against the rendered trajectory (a pass's
  world frame is its first camera's, which is the trajectory's origin);
* mapping: each keyframe's pose after local BA against its source
  frame's true pose.

`ate_rmse` and `umeyama` are a copy of the program's
`evaluation.ate_rmse` arithmetic (TUM's evaluate_ate protocol).
"""

from __future__ import annotations

import numpy as np

_PATTERN_RADIUS = 12.5


def brief_pattern(seed: int = 7, n_bits: int = 256) -> np.ndarray:
    """[n_bits, 4] float32 (x1, y1, x2, y2) sample pairs."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 31.0 / 5.0, size=(n_bits * 2, 2))
    r = np.linalg.norm(pts, axis=1)
    pts = pts * np.minimum(1.0, _PATTERN_RADIUS / np.maximum(r, 1e-9))[:, None]
    return pts.reshape(n_bits, 4).astype(np.float32)


def level_shapes(height: int, width: int, scale: float, levels: int) -> list:
    return [(max(int(round(height / scale**i)), 32), max(int(round(width / scale**i)), 32))
            for i in range(levels)]


def _resize_axis(n_in: int, n_out: int):
    """Bilinear source indices and weights along one axis: half-pixel
    centres, no antialiasing, float32."""
    scale = np.float32(n_in / n_out)
    src = scale * (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) - np.float32(0.5)
    src = np.maximum(src, np.float32(0.0))
    i0 = src.astype(np.int64)
    i1 = np.where(i0 < n_in - 1, i0 + 1, i0)
    w1 = (src - i0.astype(np.float32)).astype(np.float32)
    return i0, i1, (np.float32(1.0) - w1), w1


def resize_bilinear(img: np.ndarray, shape) -> np.ndarray:
    h0, h1, hw0, hw1 = _resize_axis(img.shape[0], shape[0])
    w0, w1, ww0, ww1 = _resize_axis(img.shape[1], shape[1])
    top = ww0[None, :] * img[h0][:, w0] + ww1[None, :] * img[h0][:, w1]
    bot = ww0[None, :] * img[h1][:, w0] + ww1[None, :] * img[h1][:, w1]
    return (hw0[:, None] * top + hw1[:, None] * bot).astype(np.float32)


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _same(x: np.ndarray) -> np.ndarray:
    return x


def pyramid(image: np.ndarray, scale: float, levels: int, rnd=_same) -> list:
    """Each level resized from the one before; `rnd` rounds each result
    (`bf16` for the control)."""
    shapes = level_shapes(image.shape[0], image.shape[1], scale, levels)
    out = [rnd(image.astype(np.float32))]
    for lvl in range(1, levels):
        out.append(rnd(resize_bilinear(out[-1], shapes[lvl])))
    return out


def blur(img: np.ndarray, size: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Separable Gaussian blur with reflect padding."""
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float32)
    taps = np.exp(-(x * x) / np.float32(2.0 * sigma * sigma)).astype(np.float32)
    taps = taps / taps.sum(dtype=np.float32)
    H, W = img.shape
    p = np.pad(img, ((half, half), (0, 0)), mode="reflect")
    rows = np.zeros((H, W), np.float32)
    for i in range(size):
        rows = rows + p[i:i + H] * taps[i]
    p = np.pad(rows, ((0, 0), (half, half)), mode="reflect")
    out = np.zeros((H, W), np.float32)
    for i in range(size):
        out = out + p[:, i:i + W] * taps[i]
    return out


def descriptors(image: np.ndarray, xy: np.ndarray, octave: np.ndarray, scale: float,
                levels: int, half_ic: int = 15, rnd=_same) -> tuple[np.ndarray, np.ndarray]:
    """The reference's (angle [N], descriptor [N, 8] uint32) at level-0
    keypoints `xy` [N, 2] of pyramid levels `octave` [N]; with `rnd=bf16`
    the pyramid and its blur are rounded to bfloat16 (the control)."""
    raw = pyramid(image, scale, levels, rnd)
    blurred = [rnd(blur(lv)) for lv in raw]
    pattern = brief_pattern()
    n = len(xy)
    angle = np.zeros(n, np.float32)
    desc = np.zeros((n, 8), np.uint32)
    yy, xx = np.mgrid[-half_ic:half_ic + 1, -half_ic:half_ic + 1].astype(np.float32)
    disk = (yy * yy + xx * xx) <= half_ic * half_ic + 1e-3
    wx, wy = np.where(disk, xx, 0).astype(np.float32), np.where(disk, yy, 0).astype(np.float32)
    shifts = np.arange(32, dtype=np.uint64)
    for lvl in np.unique(octave):
        sel = np.nonzero(octave == lvl)[0]
        s = np.float32(scale ** int(lvl))
        loc = np.rint(xy[sel].astype(np.float32) / s).astype(np.int64)
        lx, ly = loc[:, 0], loc[:, 1]
        img, bimg = raw[lvl], blurred[lvl]
        offs = np.arange(-half_ic, half_ic + 1)
        patch = img[(ly[:, None] + offs)[:, :, None], (lx[:, None] + offs)[:, None, :]]
        m10 = np.einsum("nij,ij->n", patch.astype(np.float64), wx.astype(np.float64))
        m01 = np.einsum("nij,ij->n", patch.astype(np.float64), wy.astype(np.float64))
        a = np.arctan2(m01, m10).astype(np.float32)
        ca, sa = np.cos(a), np.sin(a)

        def sample(px, py):
            x = px[None, :] * ca[:, None] - py[None, :] * sa[:, None]
            y = px[None, :] * sa[:, None] + py[None, :] * ca[:, None]
            return bimg[ly[:, None] + np.rint(y).astype(np.int64),
                        lx[:, None] + np.rint(x).astype(np.int64)]

        bits = sample(pattern[:, 2], pattern[:, 3]) > sample(pattern[:, 0], pattern[:, 1])
        words = (bits.reshape(len(sel), 8, 32).astype(np.uint64) << shifts).sum(axis=-1)
        angle[sel] = a
        desc[sel] = words.astype(np.uint32)
    return angle, desc


# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
_RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
         (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def _arc9(flags: np.ndarray) -> np.ndarray:
    """[16, ...] bool ring flags -> True where 9 or more consecutive
    (circularly) are set."""
    run = np.zeros(flags.shape[1:], np.int64)
    best = np.zeros(flags.shape[1:], np.int64)
    for k in range(32):
        run = np.where(flags[k % 16], run + 1, 0)
        best = np.maximum(best, run)
    return best >= 9


def fast_maxima(level: np.ndarray, threshold: float) -> np.ndarray:
    """[H, W] bool: FAST-9 corners at `threshold` (a contiguous arc of 9
    ring pixels all brighter or all darker than the centre by more than
    it, edge-replicated borders) whose score (the larger polarity's sum of
    differences beyond the threshold) tops every corner of its 3x3
    neighbourhood."""
    H, W = level.shape
    pad = np.pad(level.astype(np.float32), 3, mode="edge")
    diff = np.stack([pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for dy, dx in _RING]) - level
    corner = _arc9(diff > threshold) | _arc9(diff < -threshold)
    score = np.maximum(np.clip(diff - threshold, 0, None).sum(0, dtype=np.float32),
                       np.clip(-diff - threshold, 0, None).sum(0, dtype=np.float32))
    score = np.where(corner, score, -np.inf)
    sp = np.pad(score, 1, constant_values=-np.inf)
    neigh = np.stack([sp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx])
    return corner & (score >= neigh.max(0))


def keypoint_found(image: np.ndarray, xy: np.ndarray, octave: np.ndarray, scale: float,
                   levels: int, threshold: float, rnd=_same) -> np.ndarray:
    """[N] bool: whether the reference's FAST (`fast_maxima` at
    `threshold`) marks the pixel of each level-0 keypoint `xy` on its
    pyramid level `octave`; with `rnd=bf16` the pyramid is rounded to
    bfloat16 (the control)."""
    raw = pyramid(image, scale, levels, rnd)
    found = np.zeros(len(xy), bool)
    for lvl in np.unique(octave):
        sel = np.nonzero(octave == lvl)[0]
        loc = np.rint(xy[sel].astype(np.float32) / np.float32(scale ** int(lvl))).astype(np.int64)
        found[sel] = fast_maxima(raw[lvl], threshold)[loc[:, 1], loc[:, 0]]
    return found


def popcount(x: np.ndarray) -> np.ndarray:
    """Set bits per uint32 element."""
    x = x.astype(np.uint32)
    return np.unpackbits(x.view(np.uint8)).reshape(*x.shape, 32).sum(axis=-1)


def rgbd_depth(xy: np.ndarray, valid: np.ndarray, depth_map: np.ndarray) -> np.ndarray:
    """Each keypoint's depth from the depth map at its rounded pixel; -1
    where there is none or the 3x3 neighbourhood has a hole or spans more
    than 10 % of the centre's depth."""
    H, W = depth_map.shape
    ix = np.clip(np.rint(xy[:, 0]).astype(np.int64), 0, W - 1)
    iy = np.clip(np.rint(xy[:, 1]).astype(np.int64), 0, H - 1)
    d = depth_map[iy, ix]
    nb = np.stack([depth_map[np.clip(iy + dy, 0, H - 1), np.clip(ix + dx, 0, W - 1)]
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    flat = (nb.min(0) > 0) & ((nb.max(0) - nb.min(0)) < np.float32(0.1) * np.maximum(d, np.float32(1e-6)))
    return np.where(valid & (d > 0) & flat, d, np.float32(-1.0)).astype(np.float32)


def centers(T: np.ndarray) -> np.ndarray:
    """Camera centres of [N, 4, 4] Tcw."""
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def rotation_deg(T: np.ndarray, T_ref: np.ndarray) -> np.ndarray:
    """The angle of R R_ref^T per pose, in degrees, from its sine (the
    skew part) and cosine (the trace) together, so that a rotation
    slightly off SO(3) still reads its small angle."""
    R = np.einsum("nij,nkj->nik", T[:, :3, :3], T_ref[:, :3, :3])
    sin2 = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    return np.degrees(np.arctan2(np.linalg.norm(sin2, axis=1), np.trace(R, axis1=1, axis2=2) - 1.0))


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid transform src -> dst ([N, 3] each).
    Returns (s, R, t) with dst ~ s R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def aligned_errors(est_cw: np.ndarray, gt_cw: np.ndarray) -> np.ndarray:
    """Camera-centre errors after rigid Umeyama alignment of est to gt."""
    c_est, c_gt = centers(np.asarray(est_cw, np.float64)), centers(np.asarray(gt_cw, np.float64))
    s, R, t = umeyama(c_est, c_gt)
    return np.linalg.norm((s * (R @ c_est.T)).T + t - c_gt, axis=1)


def ate_rmse(est_cw: np.ndarray, gt_cw: np.ndarray) -> float:
    """ATE RMSE over camera centres after rigid alignment."""
    err = aligned_errors(est_cw, gt_cw)
    return float(np.sqrt(np.mean(err**2)))
