"""Sim(3) similarity transforms (rotation + translation + scale).

Port of `orbslam2_tpu.geometry.sim3`. A similarity is the tuple ``(s, R,
t)`` of tensors with broadcastable batch dimensions, or the 8-float packed
vector ``(s, qw, qx, qy, qz, tx, ty, tz)`` a map stores. exp/log use the
closed-form Sim(3) formulas (sigma = log s), so the pose graph can take
tangent-space Gauss-Newton steps; both work under `torch.func` transforms,
and `log` has a finite derivative at identity (through `se3.log_so3`).
"""

from __future__ import annotations

import torch

from orbslam2_tpu_torch.geometry import se3

_EPS = 1e-8


def make(s, R: torch.Tensor, t: torch.Tensor):
    return (torch.as_tensor(s, dtype=R.dtype, device=R.device), R, t)


def identity(dtype=torch.float32, device=None):
    return (torch.ones((), dtype=dtype, device=device), torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def from_se3(T: torch.Tensor):
    return (torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device), se3.rotation(T),
            se3.translation(T))


def to_se3(S) -> torch.Tensor:
    """Drop the scale into the translation: T = [R, t/s]."""
    s, R, t = S
    return se3.make(R, t / s[..., None])


def apply(S, p: torch.Tensor) -> torch.Tensor:
    """q = s * R p + t."""
    s, R, t = S
    return s[..., None] * torch.einsum("...ij,...j->...i", R, p) + t


def compose(A, B):
    """A o B: s = sa sb, R = Ra Rb, t = sa Ra tb + ta."""
    sa, Ra, ta = A
    sb, Rb, tb = B
    return (sa * sb, Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta)


def inverse(S):
    s, R, t = S
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return (sinv, Rt, -sinv[..., None] * torch.einsum("...ij,...j->...i", Rt, t))


def pack(S) -> torch.Tensor:
    """(s, R, t) -> [..., 8] = (s, qw, qx, qy, qz, tx, ty, tz)."""
    s, R, t = S
    return torch.cat([s[..., None], se3.rot_to_quat(R), t], dim=-1)


def unpack(v: torch.Tensor):
    return (v[..., 0], se3.quat_to_rot(v[..., 1:5]), v[..., 5:8])


def _w_matrix(phi, sig, s):
    """The W matrix of t = W rho, with the coefficients folding in the
    e^sigma terms (Strasdat's expmap), for exp and log alike."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    Wx = se3.hat(phi)
    Wx2 = Wx @ Wx
    small_sig = torch.abs(sig) < 1e-3
    # A0 = (e^sigma - 1)/sigma
    # a Python scalar inside `torch.where` would carry a float64 tangent
    # under forward-mode AD, hence `ones_like`
    A0 = torch.where(small_sig, 1.0 + sig / 2.0 + sig * sig / 6.0,
                     (s - 1.0) / torch.where(small_sig, torch.ones_like(sig), sig))
    small_th = theta2 < 1e-4
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = torch.clamp(sig * sig + theta2, min=_EPS)
    a = s * sin_t
    b = s * cos_t
    B = torch.where(
        small_th,
        torch.where(small_sig, 0.5 + sig / 3.0, (s * (sig - 1.0) + 1.0) / denom),
        (a * sig + (1.0 - b) * theta) / (torch.clamp(theta, min=_EPS) * denom),
    )
    C = torch.where(
        small_th,
        torch.where(small_sig, 1.0 / 6.0 + sig / 8.0,
                    (s * (0.5 * sig * sig - sig + 1.0) - 1.0)
                    / torch.clamp(sig * denom, min=_EPS)),
        (A0 - ((b - 1.0) * sig + a * theta) / denom) / torch.clamp(theta2, min=_EPS),
    )
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Wx.shape)
    return A0[..., None, None] * eye + B[..., None, None] * Wx + C[..., None, None] * Wx2


def exp(xi: torch.Tensor):
    """sim(3) exp: [..., 7] = (rho(3), phi(3), sigma) -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    W = _w_matrix(phi, sigma, s)
    return (s, se3.exp_so3(phi), (W @ rho[..., None])[..., 0])


def log(S) -> torch.Tensor:
    """Inverse of exp, by solving W rho = t (a batched 3x3 solve)."""
    s, R, t = S
    sigma = torch.log(s)
    phi = se3.log_so3(R)
    W = _w_matrix(phi, sigma, s)
    return torch.cat([_solve3(W, t), phi, sigma[..., None]], dim=-1)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for batched 3x3 A by the adjugate: `torch.linalg.solve`
    reads its status back to the host on the card, and W is never near
    singular (W -> A0 I as phi -> 0)."""
    c0 = torch.linalg.cross(A[..., 1, :], A[..., 2, :])
    c1 = torch.linalg.cross(A[..., 2, :], A[..., 0, :])
    c2 = torch.linalg.cross(A[..., 0, :], A[..., 1, :])
    det = torch.sum(A[..., 0, :] * c0, dim=-1)
    adj_b = c0 * b[..., :1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]
    return adj_b / det[..., None]


def tangent_jacobian(f, x: torch.Tensor) -> torch.Tensor:
    """The forward-mode Jacobian of `f` at x [B, n], for a function whose
    output depends on each row of x independently (or on one row, B = 1):
    column k is f's tangent along e_k in every row at once. One forward
    pass: x is repeated along a new leading dimension of n, one basis
    direction each, so `f` must broadcast over a leading dimension.
    Returns [*f(x).shape, n].

    This stands for the reference's `vmap(jacfwd(...))`. (Under `vmap`,
    `torch.func.jacfwd` of a function on one 7-vector works on 0-d slices,
    and a 0-d tensor times a Python float gets a float64 tangent there.)"""
    n = x.shape[-1]
    xs = x.expand((n,) + x.shape).contiguous()
    basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :].expand((n,) + x.shape).contiguous()
    return torch.func.jvp(f, (xs,), (basis,))[1].movedim(0, -1)
