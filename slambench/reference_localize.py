"""The plain reference of one localization-mode frame: plain `torch`, float32,
with TF32 off in both `allow_tf32` flags. It imports nothing of the program
or of the JAX package and runs no hand-written kernel; it is written from
the port's documented design of the localization step, not by calling it.

What it computes, from the frozen map's tensors, the frame's features and
the previous frame's state:

* `track_frame`: the fused track step and the resolve's decision. The
  coarse stage matches the reference keyframe's bound features (ratio 0.7,
  Hamming <= 50, the rotation histogram) and refines the last pose with
  the short schedule (2 rounds of 6 iterations); when that holds fewer than
  15 inliers, the motion model predicts the pose, searches the last
  frame's points within 7 px a scale level (14 px when fewer than 20
  match; ratio 0.9, the rotation histogram) and refines the prediction the
  same way. Then the local map (the observers of the bound points and
  their covisible keyframes, the points they bind, the most relevant
  keyframe's first) is searched by projection twice (radius x1.0 and
  x0.6, ratio 0.8, octave band +-1) with the pose refined after each
  (3 x 6, then 4 x 6). The decision: "map" when tracking holds and at
  least 30 inliers remain (the local-map gate), "VO" when tracking holds
  but the gate fails (the hand-over to the odometry), "LOST" otherwise.
  The next reference keyframe is returned too, from the frame's tracked
  points (the final bindings): the reference keyframe while it observes
  at least half as many of them as the keyframe observing most of them,
  else that keyframe. After a "map" frame it is the next frame's
  reference keyframe (ORB-SLAM2's UpdateLocalKeyFrames makes the keyframe
  observing most of the frame's matches mpReferenceKF every frame).
* `odometry_frame`: the frame-to-frame visual odometry (mbVO) of a frame
  on which relocalization failed: the last frame's features with depth,
  backprojected at its pose, predicted by the motion model, matched within
  14 px a scale level (ratio 0.9, the rotation histogram) and refined by
  the full schedule (4 rounds of 10 iterations). "VO" when at least 10
  inliers hold it, "LOST" otherwise.

Relocalization is out of its scope: a frame that reaches it ends the
comparison there, and the caller reports it.

The robust pose optimisation is ORB-SLAM2's Optimizer::PoseOptimization
as `solvers/pose_opt.py` documents it: monocular (u, v) and stereo
(u, v, uR) reprojection edges with information 1 / sigma^2 of the
keypoint's octave, Huber kernels (delta sqrt(5.991) mono, sqrt(7.815)
stereo) in the first two rounds only, Gauss-Newton steps on a left-
multiplied twist with the normal equations damped by 1e-5 (trace / 6 +
1e-6), and after each round every edge reclassified: an inlier has depth
above 1 mm and chi2 <= 5.991 (mono) or 7.815 (stereo).

Departures of the port from ORB-SLAM2's published Tracking::Track, which
this reference follows:

* the coarse stage tries the reference keyframe first, on every frame,
  and falls back to the motion model only when that is weak; ORB-SLAM2
  tries the motion model first and the reference keyframe only after a
  failure;
* the hand-over to the odometry (mbVO) is triggered by the local-map gate
  (fewer than 30 inliers after the local-map passes while coarse tracking
  holds), not by ORB-SLAM2's `nmatchesMap < 10` count of map matches;
* the odometry's temporary points (the last frame's features with depth)
  are made only in mbVO; ORB-SLAM2's UpdateLastFrame makes them on every
  frame of an RGB-D or stereo session.

`precision` (torch.bfloat16 for the benchmark's control) rounds every
stage of the pose optimisation to that precision; everything else stays
float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

TH_LOW = 50
HISTO_LENGTH = 30
CHI2_MONO = 5.991
CHI2_STEREO = 7.815
# coarse, local-map and odometry schedules: (rounds, iterations)
COARSE = (2, 6)
LOCAL = ((1.0, 3, 6), (0.6, 4, 6))
ODOMETRY = (4, 10)
_FAR = 1 << 20


class Settings(NamedTuple):
    """The camera and the tracking constants the step reads."""

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    width: int
    height: int
    scale_factor: float
    num_levels: int
    min_track: int = 10          # inliers for a stage to hold
    min_track_local: int = 30    # the local-map gate
    max_dist: int = 64           # Hamming gate of the projection searches
    radius_th: float = 7.0       # motion-model radius, px a scale level
    vo_radius: float = 14.0      # odometry radius, px a scale level
    max_local_kfs: int = 80
    max_local_points: int = 8192

    @classmethod
    def from_settings(cls, s: dict) -> "Settings":
        """From an ORB-SLAM2 settings file's keys (as `cell.parse_settings`
        reads them) and the port's capacities (`Port.*`). The camera has no
        distortion, as TUM3.yaml's: the image bounds are its edges."""
        if any(float(s.get(f"Camera.{k}", 0.0)) != 0.0 for k in ("k1", "k2", "p1", "p2", "k3")):
            raise ValueError("the reference takes an undistorted camera")
        return cls(fx=float(s["Camera.fx"]), fy=float(s["Camera.fy"]),
                   cx=float(s["Camera.cx"]), cy=float(s["Camera.cy"]),
                   bf=float(s["Camera.bf"]), width=int(s["Camera.width"]),
                   height=int(s["Camera.height"]),
                   scale_factor=float(s["ORBextractor.scaleFactor"]),
                   num_levels=int(s["ORBextractor.nLevels"]),
                   max_local_kfs=int(s.get("Port.max_local_keyframes", 80)),
                   max_local_points=int(s.get("Port.max_local_points", 8192)))

    def scales(self, device) -> torch.Tensor:
        return torch.tensor([self.scale_factor ** i for i in range(self.num_levels)],
                            dtype=torch.float32, device=device)


class Outcome(NamedTuple):
    decision: str                # "map", "VO" or "LOST"
    Tcw: torch.Tensor            # [4, 4] the pose the frame returns
    n_inliers: int
    point_idx: torch.Tensor      # [S] the map point (or, in the odometry, the
    #                              last frame's feature) each feature binds, -1 none
    local_ref: int = -1          # the next reference keyframe


def full_precision() -> None:
    """No TF32 in products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def transform(T, p):
    """World points [N, 3] into the frame of T [4, 4]."""
    return torch.einsum("ij,nj->ni", T[:3, :3], p) + T[:3, 3]


def invert(T):
    R, t = T[:3, :3], T[:3, 3]
    out = torch.zeros_like(T)
    out[:3, :3] = R.T
    out[:3, 3] = -(R.T @ t)
    out[3, 3] = 1.0
    return out


def centre(T):
    return -(T[:3, :3].T @ T[:3, 3])


def pixels(pc, s: Settings):
    z = torch.where(pc[:, 2].abs() < 1e-6, 1e-6, pc[:, 2])
    return torch.stack([pc[:, 0] / z * s.fx + s.cx, pc[:, 1] / z * s.fy + s.cy], dim=-1)


def skew(v):
    o = torch.zeros_like(v[..., 0])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def twist_exp(xi):
    """se(3) twist (rho, phi) [6] -> [4, 4], with the series near 0."""
    rho, phi = xi[:3], xi[3:]
    th2 = torch.sum(phi * phi)
    th = torch.sqrt(torch.clamp(th2, min=1e-8))
    small = th2 < 1e-4
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - a) / th2)
    W = skew(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    out = torch.eye(4, dtype=xi.dtype, device=xi.device)
    out[:3, :3] = eye + a * W + b * W2
    out[:3, 3] = (eye + b * W + c * W2) @ rho
    return out


def pose_gap(Ta, Tb) -> tuple[float, float]:
    """(camera-centre distance in m, rotation angle in degrees, from its
    sine and cosine together) between two poses, in float64."""
    Ta, Tb = Ta.double().cpu(), Tb.double().cpu()
    dt = float(torch.linalg.norm(centre(Ta) - centre(Tb)))
    R = Ta[:3, :3].T @ Tb[:3, :3]
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    cos = (torch.trace(R) - 1.0) / 2
    return dt, math.degrees(math.atan2(float(torch.linalg.norm(w)), float(cos)))


# ---------------------------------------------------------------------------
# descriptor matching
# ---------------------------------------------------------------------------

def hamming(a, b):
    """[A, 8] x [B, 8] int32 words -> [A, B] int32 bit distances, one byte
    table look-up a byte."""
    table = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32,
                         device=a.device)
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for w in range(a.shape[1]):
        x = torch.bitwise_xor(a[:, w, None], b[None, :, w]).contiguous()
        out += table[x.view(torch.uint8).to(torch.int64)].reshape(a.shape[0], b.shape[0], 4).sum(-1,
                                                                     dtype=torch.int32)
    return out


def match(desc_a, desc_b, gate, max_dist, ratio, angle_a=None, angle_b=None):
    """Each A's best B under `gate` (the first on ties), kept where it is
    within `max_dist`, at most `ratio` of the second best, and (with
    angles) in one of the rotation histogram's three main bins; a B taken
    by several A goes to the nearest, then the lowest A. Returns the [B]
    index of the A that each B got, -1 for none."""
    d = torch.where(gate, hamming(desc_a, desc_b), _FAR)
    best, j = torch.min(d, dim=1)
    second = torch.min(d.scatter(1, j[:, None], _FAR), dim=1).values
    ok = best <= max_dist
    if ratio < 1.0:
        ok = ok & (best.float() <= ratio * second.float())
    if angle_a is not None:
        ok = ok & main_rotation_bins(angle_a - angle_b[j], ok)
    n_b = desc_b.shape[0]
    a = torch.nonzero(ok)[:, 0]
    key = (j[a].long() * 512 + best[a].long()) * (desc_a.shape[0] + 1) + a
    order = torch.argsort(key)
    a, jb = a[order], j[a[order]]
    first = torch.ones_like(jb, dtype=torch.bool)
    first[1:] = jb[1:] != jb[:-1]
    got = torch.full((n_b,), -1, dtype=torch.int64, device=desc_a.device)
    got[jb[first]] = a[first]
    return got


def main_rotation_bins(diff, ok):
    """The angle differences in the 3 most filled of 30 bins over the
    turn; the second and third only where they hold more than a tenth of
    the first; equal counts rank the lower bin first."""
    two_pi = 2.0 * math.pi
    bins = torch.clamp((torch.remainder(diff, two_pi) * (HISTO_LENGTH / two_pi)).long(),
                       0, HISTO_LENGTH - 1)
    hist = torch.bincount(bins[ok], minlength=HISTO_LENGTH)
    rank = torch.argsort(-hist * HISTO_LENGTH + torch.arange(HISTO_LENGTH, device=diff.device))
    keep = bins == rank[0]
    for r in (1, 2):
        if hist[rank[r]] > 0.1 * hist[rank[0]]:
            keep = keep | (bins == rank[r])
    return keep


def near(uv, xy, radius, valid_a, valid_b, octave_a, octave_b):
    """[A, B]: B within radius[A] px of uv[A], its octave within one of A's."""
    d = uv[:, None, :] - xy[None, :, :]
    band = (octave_b[None, :] - octave_a[:, None]).abs() <= 1
    return ((torch.sum(d * d, dim=-1) <= radius[:, None] ** 2) & band
            & valid_a[:, None] & valid_b[None, :])


# ---------------------------------------------------------------------------
# the robust pose optimisation
# ---------------------------------------------------------------------------

def optimise_pose(T0, pw, uv, ur, info, mask, s: Settings, rounds: int, iters: int,
                  precision=torch.float32):
    """Returns (Tcw, inlier mask [N], inlier count)."""
    if precision == torch.float32:
        def q(x):
            return x
    else:
        def q(x):
            return x.to(precision).to(torch.float32)
    stereo = ur >= 0
    th = torch.where(stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.sqrt(th)
    eye6 = torch.eye(6, device=T0.device)

    def residuals(T):
        pc = q(transform(T, pw))
        z = pc[:, 2]
        front = z > 1e-3
        iz = 1.0 / torch.where(front, z, 1.0)
        u = s.fx * pc[:, 0] * iz + s.cx
        v = s.fy * pc[:, 1] * iz + s.cy
        r = q(torch.stack([uv[:, 0] - u, uv[:, 1] - v,
                           torch.where(stereo, ur - (u - s.bf * iz), 0.0)], -1))
        return pc, iz, r, front

    def chi2(r):
        return (r[:, 0] ** 2 + r[:, 1] ** 2 + torch.where(stereo, r[:, 2] ** 2, 0.0)) * info

    T = T0.clone()
    inl = mask.clone()
    for rnd in range(rounds):
        for _ in range(iters):
            pc, iz, r, front = residuals(T)
            act = inl & front
            r = torch.where(act[:, None], r, 0.0)
            zero = torch.zeros_like(iz)
            du = torch.stack([s.fx * iz, zero, -s.fx * pc[:, 0] * iz * iz], -1)
            dv = torch.stack([zero, s.fy * iz, -s.fy * pc[:, 1] * iz * iz], -1)
            dr = du + torch.stack([zero, zero, s.bf * iz * iz], -1)
            dproj = torch.stack([du, dv, torch.where(stereo[:, None], dr, 0.0)], 1)
            dpc = torch.cat([torch.eye(3, device=T.device).expand(len(pc), 3, 3), -skew(pc)], -1)
            J = q(torch.where(act[:, None, None], -(dproj @ dpc), 0.0))
            e = torch.sqrt(torch.clamp(chi2(r), min=1e-12))
            w = info * act
            if rnd < 2:
                w = w * torch.where(e > delta, delta / e, 1.0)
            JW = J * w[:, None, None]
            H = q(torch.einsum("nij,nik->jk", JW, J))
            g = q(torch.einsum("nij,ni->j", JW, r))
            H = H + 1e-5 * eye6 * (torch.trace(H) / 6.0 + 1e-6)
            L, bad = torch.linalg.cholesky_ex(H)
            dx = q(torch.cholesky_solve(-g[:, None], L)[:, 0])
            # a failed or empty step leaves the pose as it is
            step = (bad == 0) & torch.isfinite(dx).all() & (torch.sum(g * g) > 1e-20)
            T = q(twist_exp(torch.where(step, dx, 0.0)) @ T)
        _, _, r, front = residuals(T)
        inl = mask & front & (chi2(torch.where(mask[:, None], r, 0.0)) <= th)
    return T, inl, int(inl.sum())


# ---------------------------------------------------------------------------
# the frame's stages
# ---------------------------------------------------------------------------

def _octave_info(octave, s: Settings, device):
    """1 / sigma^2 of each keypoint's octave: 1 / scale_factor^(2 octave)."""
    info = torch.tensor([1.0 / s.scale_factor ** (2 * i) for i in range(s.num_levels)],
                        dtype=torch.float32, device=device)
    return info[octave.long().clamp(0, s.num_levels - 1)]


def _observations(bind, frame, m, s: Settings):
    pid = bind.long().clamp(0, m.mp_pos.shape[0] - 1)
    mask = (bind >= 0) & m.mp_valid[pid] & frame.valid
    return m.mp_pos[pid], frame.xy, frame.ur, _octave_info(frame.octave, s, bind.device), mask


def _refine(T0, bind, frame, m, s, schedule, precision):
    T, inl, n = optimise_pose(T0, *_observations(bind, frame, m, s), s, *schedule,
                              precision=precision)
    return T, torch.where(inl, bind, -1), n


def keyframe_match(m, kf: int, frame):
    """The reference keyframe's bound features against the frame."""
    pid = m.kf_point_idx[kf]
    ok = m.kf_feat_valid[kf] & (pid >= 0) & m.mp_valid[pid.long().clamp(min=0)]
    got = match(m.kf_desc[kf], frame.desc, ok[:, None] & frame.valid[None, :], TH_LOW, 0.7,
                m.kf_angle[kf], frame.angle)
    return torch.where(got >= 0, pid[got.clamp(min=0)], -1)


def motion_match(m, prev, T_pred, frame, s: Settings, radius_px: float):
    """The last frame's bound points, projected at the predicted pose."""
    pid = prev.point_idx.long().clamp(0, m.mp_pos.shape[0] - 1)
    pc = transform(T_pred, m.mp_pos[pid])
    seen = (prev.point_idx >= 0) & m.mp_valid[pid] & (pc[:, 2] > 0.1)
    sc = s.scales(frame.xy.device)
    radius = radius_px * sc[prev.frame.octave.long().clamp(0, s.num_levels - 1)]
    gate = near(pixels(pc, s), frame.xy, radius, seen, frame.valid, prev.frame.octave,
                frame.octave)
    got = match(prev.frame.desc, frame.desc, gate, s.max_dist, 0.9, prev.frame.angle,
                frame.angle)
    return torch.where(got >= 0, prev.point_idx[got.clamp(min=0)], -1)


def kf_votes(m, bind):
    """[K] how many of the bound points each valid keyframe observes."""
    P, K = m.mp_pos.shape[0], m.kf_valid.shape[0]
    pid = bind.long().clamp(0, P - 1)
    bound = (bind >= 0) & m.mp_valid[pid]
    obs = m.mp_obs_kf[pid]
    votes = torch.bincount(obs[bound[:, None] & (obs >= 0)].long(), minlength=K)[:K]
    return torch.where(m.kf_valid, votes, 0)


def next_reference(m, bind, ref_kf: int) -> int:
    """`ref_kf` while it observes at least half as many of the bound
    points as the keyframe that observes most of them (the lowest id among
    equals), else that keyframe; -1 where none is bound."""
    if not bool((bind >= 0).any()):
        return -1
    votes = kf_votes(m, bind)
    best = int(torch.nonzero(votes == votes.max())[0, 0])
    return ref_kf if 2 * int(votes[ref_kf]) >= int(votes[best]) else best


def local_map(m, bind, s: Settings):
    """(local point ids [M], their mask): the keyframes that observe the
    bound points (by how many), then the keyframes most covisible with
    them, ranked, at most `max_local_kfs`; their bound points, the best
    ranked keyframe's first and the highest id first within it, at most
    `max_local_points`."""
    P, K = m.mp_pos.shape[0], m.kf_valid.shape[0]
    dev = bind.device
    votes = kf_votes(m, bind)
    voters = votes > 0
    boost = torch.where(voters[:, None], m.covis.long(), 0).amax(0).clamp(min=0)
    score = torch.where(m.kf_valid, votes * 1000 + torch.where(voters, 0, boost), -1)
    L = min(s.max_local_kfs, K)
    kfs = torch.argsort(-score * (K + 1) + torch.arange(K, device=dev))[:L]
    kf_ok = score[kfs] > 0
    ids = m.kf_point_idx[kfs].long()
    rank = torch.arange(L, device=dev)[:, None].expand_as(ids)
    sel = kf_ok[:, None] & (ids >= 0)
    first = torch.full((P,), L, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, ids[sel], rank[sel], "amin")
    flagged = (first < L) & m.mp_valid
    pts = torch.arange(P, device=dev)
    key = torch.where(flagged, (L - first) * (P + 1) + pts, -1)
    order = torch.argsort(-key * (P + 1) + pts)[:min(s.max_local_points, P)]
    return order, key[order] >= 0


def project_search(m, pts, pts_ok, T, bind, frame, s: Settings, radius_mult: float):
    """The local points that lie in the frame's view (in front, inside the
    image, within their scale band 0.8x-1.2x, seen within 60 degrees of
    their mean view, not bound yet), matched by projection into the
    unbound features, each within 2.5 px (4 px beyond 3.6 degrees off its
    mean view) times `radius_mult` a scale level of its predicted octave;
    merged into `bind`."""
    pw = m.mp_pos[pts]
    pc = transform(T, pw)
    uv = pixels(pc, s)
    rays = pw - centre(T)
    dist = torch.linalg.norm(rays, dim=-1)
    cosv = torch.sum(rays * m.mp_normal[pts], dim=-1) / torch.clamp(dist, min=1e-9)
    inside = (uv[:, 0] >= 0) & (uv[:, 0] < s.width) & (uv[:, 1] >= 0) & (uv[:, 1] < s.height)
    band = (dist >= m.mp_min_dist[pts] * 0.8) & (dist <= m.mp_max_dist[pts] * 1.2)
    taken = torch.zeros(m.mp_pos.shape[0], dtype=torch.bool, device=pw.device)
    taken[bind[bind >= 0].long()] = True
    view = pts_ok & (pc[:, 2] > 0.1) & inside & band & (cosv > 0.5) & ~taken[pts]
    sc = s.scales(pw.device)
    level = torch.log(torch.clamp(m.mp_max_dist[pts] / torch.clamp(dist, min=1e-9), min=1e-9))
    octave = torch.clamp(torch.ceil(level / torch.log(sc[1])).to(torch.int32), 0,
                         s.num_levels - 1)
    radius = torch.where(cosv > 0.998, 2.5, 4.0) * radius_mult * sc[octave.long()]
    gate = near(uv, frame.xy, radius, view, frame.valid & (bind < 0), octave, frame.octave)
    got = match(m.mp_desc[pts], frame.desc, gate, s.max_dist, 0.8)
    return torch.where(bind >= 0, bind, torch.where(got >= 0, pts[got.clamp(min=0)], -1).to(
        bind.dtype))


class Previous(NamedTuple):
    """The state the step starts from: the last frame's features, the map
    point each binds, its pose, the motion model and the reference
    keyframe."""

    frame: object          # .xy .ur .depth .octave .angle .desc .valid
    point_idx: torch.Tensor
    Tcw: torch.Tensor
    velocity: Optional[torch.Tensor]
    has_velocity: bool
    ref_kf: int


@torch.no_grad()
def track_frame(m, frame, prev: Previous, s: Settings, precision=torch.float32) -> Outcome:
    """One steady-state frame of localization mode against the frozen map
    `m` (any object with the map's tensors as attributes: kf_valid,
    kf_desc, kf_angle, kf_feat_valid, kf_point_idx, mp_valid, mp_pos,
    mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_obs_kf, covis)."""
    full_precision()
    bind_ref = keyframe_match(m, prev.ref_kf, frame)
    T_ref, seed_ref, n_ref = _refine(prev.Tcw, bind_ref, frame, m, s, COARSE, precision)
    ok_ref = n_ref >= s.min_track
    if ok_ref and n_ref >= 15:
        T, bind, coarse_ok = T_ref, seed_ref, True
    else:
        v = prev.velocity if prev.velocity is not None else torch.eye(4, device=prev.Tcw.device)
        T_pred = v @ prev.Tcw
        b1 = motion_match(m, prev, T_pred, frame, s, s.radius_th)
        bind_mm = b1 if int((b1 >= 0).sum()) >= 20 else motion_match(m, prev, T_pred, frame, s,
                                                                       2 * s.radius_th)
        T_mm, seed_mm, n_mm = _refine(T_pred, bind_mm, frame, m, s, COARSE, precision)
        ok_mm = n_mm >= s.min_track and int((bind_mm >= 0).sum()) >= 20 and prev.has_velocity
        T, bind = (T_mm, seed_mm) if ok_mm else (T_ref, seed_ref)
        coarse_ok = ok_mm or ok_ref
    pts, pts_ok = local_map(m, bind, s)
    (r1, rounds1, iters1), (r2, rounds2, iters2) = LOCAL
    T1, b1, n1 = _refine(T, project_search(m, pts, pts_ok, T, bind, frame, s, r1), frame, m, s,
                         (rounds1, iters1), precision)
    if n1 >= s.min_track:
        T, bind = T1, b1
    T2, b2, n2 = _refine(T, project_search(m, pts, pts_ok, T, bind, frame, s, r2), frame, m, s,
                         (rounds2, iters2), precision)
    if n2 >= n1 and n2 >= s.min_track:
        T, bind, n = T2, b2, n2
    else:
        n = n1 if n1 >= s.min_track else 0
    holds = (coarse_ok or n >= 3 * s.min_track_local) and n >= s.min_track
    decision = "map" if holds and n >= s.min_track_local else ("VO" if holds else "LOST")
    return Outcome(decision, T, n, bind, next_reference(m, bind, prev.ref_kf))


@torch.no_grad()
def odometry_frame(frame, last, last_Tcw, velocity, s: Settings,
                   precision=torch.float32) -> Outcome:
    """The visual odometry's step from the last frame `last` (its pose
    `last_Tcw`, the motion model `velocity` or None), for a frame on which
    relocalization failed. Its bindings index `last`'s features."""
    full_precision()
    dev = last_Tcw.device
    T_pred = (velocity if velocity is not None else torch.eye(4, device=dev)) @ last_Tcw
    z = last.depth
    pc_last = torch.stack([(last.xy[:, 0] - s.cx) / s.fx * z, (last.xy[:, 1] - s.cy) / s.fy * z,
                           z], -1)
    pw = transform(invert(last_Tcw), pc_last)
    pc = transform(T_pred, pw)
    seen = last.valid & (z > 0) & (pc[:, 2] > 0.1)
    sc = s.scales(dev)
    radius = s.vo_radius * sc[last.octave.long().clamp(0, s.num_levels - 1)]
    gate = near(pixels(pc, s), frame.xy, radius, seen, frame.valid, last.octave, frame.octave)
    got = match(last.desc, frame.desc, gate, s.max_dist, 0.9, last.angle, frame.angle)
    mask = (got >= 0) & frame.valid
    T, inl, n = optimise_pose(T_pred, pw[got.clamp(min=0)], frame.xy, frame.ur,
                              _octave_info(frame.octave, s, dev), mask, s, *ODOMETRY,
                              precision=precision)
    ok = n >= s.min_track
    return Outcome("VO" if ok else "LOST", T if ok else T_pred, n, torch.where(inl, got, -1))
