"""SE(3) rigid transforms as batched PyTorch ops.

Port of `orbslam2_tpu.geometry.se3`. Poses are 4x4 row-major matrices
``T = [[R, t], [0, 1]]`` mapping world to camera coordinates (``Tcw``).
All functions broadcast over leading batch dimensions and work under
`torch.func` transforms.

The exp/log maps implement the standard se(3) <-> SE(3) formulas with
Taylor fallbacks near theta=0 so derivatives stay finite.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye3(w, W.shape) + a * W + b * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3].

    Differentiable at identity: the arccos input is clamped strictly inside
    (-1, 1) and the small-angle branch uses sin^2(theta) = |w|^2 (a
    polynomial in R) instead of theta, so no selected value depends on a
    non-finite tangent (forward-mode derivatives of an exactly satisfied
    residual stay finite)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin2 = torch.sum(w * w, dim=-1)         # sin^2(theta), smooth in R
    theta = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    sin_t = torch.sin(theta)
    small = (cos_t > 0.99995)[..., None]    # theta < 1e-2
    scale = torch.where(
        small,
        0.5 + sin2[..., None] / 12.0,
        theta[..., None] / torch.clamp(2.0 * sin_t[..., None], min=_EPS),
    )
    w_generic = 2.0 * scale * w
    # near theta = pi recover the axis from the symmetric part
    # diag(R) = cos t I + (1 - cos t) a a^T
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_t[..., None]) / torch.clamp(1.0 - cos_t[..., None], min=_EPS), min=0.0
    )
    axis = torch.sqrt(axis2)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    a0, a1, a2 = axis[..., 0], axis[..., 1], axis[..., 2]
    dom0 = (a0 >= a1) & (a0 >= a2)
    dom1 = (~dom0) & (a1 >= a2)
    one = torch.ones_like(a0)
    sign1 = torch.where(dom0, torch.sign(s01 + _EPS), one)
    sign2 = torch.where(dom0, torch.sign(s02 + _EPS), torch.where(dom1, torch.sign(s12 + _EPS), one))
    sign0 = torch.where(dom0, one, torch.where(dom1, torch.sign(s01 + _EPS), torch.sign(s02 + _EPS)))
    axis_signed = torch.stack([a0 * sign0, a1 * sign1, a2 * sign2], dim=-1)
    w_pi = theta[..., None] * axis_signed
    return torch.where(near_pi[..., None], w_pi, w_generic)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: twist [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    W = hat(phi)
    W2 = W @ W
    small = theta2 < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    eye = _eye3(xi, W.shape)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    t = (V @ rho[..., None])[..., 0]
    return make(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log: [..., 4, 4] -> twist [..., 6] (rho, phi)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = log_so3(R)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    W = hat(phi)
    W2 = W @ W
    small = theta2 < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - a / (2.0 * b)) / theta2)
    Vinv = _eye3(T, W.shape) - 0.5 * W + coef * W2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] from R [..., 3, 3] and t [..., 3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # built on the device by a comparison: a row copied from the host, or
    # a Python number written into it, waits for the card's queue
    bottom = (torch.arange(4, device=R.device) == 3).to(R.dtype)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid inverse (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points: T [..., 4, 4], p [..., 3] -> [..., 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...j->...i", R, p) + t


def camera_center(Tcw: torch.Tensor) -> torch.Tensor:
    """Camera center in world coords: Ow = -R^T t."""
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", R, t)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z), w >= 0.

    Branch-free Shepperd-style method: all four candidates are computed and
    the best-conditioned one is selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4 candidates, 4 components]
    mags = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(mags, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.take_along_dim(cands, idx, dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) via quaternion round-trip."""
    return quat_to_rot(rot_to_quat(R))
