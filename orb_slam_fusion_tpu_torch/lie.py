"""Batched SO(3)/SE(3) operations (the SE3 subset of the reference's lie.py).

Counterpart of ``orb_slam_fusion_tpu/lie.py``. Conventions are the same:
rotations are ``(..., 3, 3)``, SE(3) is ``(R, t)`` acting as ``R @ x + t``,
and tangent vectors are ``[v, w]`` (translation first). Small-angle cases
use ``torch.where`` on Taylor expansions, so every function is branch-free,
broadcasts over leading batch dimensions and differentiates under
``torch.func.jacfwd`` (the inertial solvers' Jacobians). Sim(3) is a
triple ``(s, R, t)`` acting as ``s * R @ x + t`` with tangent
``[v, w, sigma]`` (sigma the log scale), as in the reference.
``atan2``, ``exp``, ``log`` and the ``sin``/``cos`` of the Sim(3) and
inverse-Jacobian coefficients are the reference's (``utils/libm.py``);
those of ``so3_exp`` and the left Jacobian are the library's (ROADMAP C15).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import resolve_device
from .utils import libm

_EPS = 1e-8


class SE3(NamedTuple):
    """Batched rigid transform x -> R @ x + t."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


class Sim3(NamedTuple):
    """Batched similarity transform x -> s * R @ x + t."""

    s: torch.Tensor  # (...,)
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product '...ij,...j->...i'."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (...,3) vectors -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _theta_terms(w: torch.Tensor):
    th2_raw = torch.sum(w * w, dim=-1)
    small = th2_raw < 1e-8
    th2_safe = torch.where(small, torch.ones_like(th2_raw), th2_raw)
    return th2_raw, small, torch.sqrt(th2_safe), th2_safe


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map R^3 -> SO(3) (Rodrigues), batched."""
    th2, small, th, _ = _theta_terms(w)
    W = hat(w)
    W2 = W @ W
    # the library's sin and cos: the reference's (libm) moved the parity
    # tests of the flat inertial steps (ROADMAP C15)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0 (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(pivot, a, b, c, d):
        s = torch.sqrt(torch.clamp(pivot, min=_EPS)) * 2.0
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1)

    p0 = 1.0 + tr
    p1 = 1.0 + m00 - m11 - m22
    p2 = 1.0 - m00 + m11 - m22
    p3 = 1.0 - m00 - m11 + m22
    qs = torch.stack([
        cand(p0, p0, m21 - m12, m02 - m20, m10 - m01),
        cand(p1, m21 - m12, p1, m01 + m10, m02 + m20),
        cand(p2, m02 - m20, m01 + m10, p2, m12 + m21),
        cand(p3, m10 - m01, m02 + m20, m12 + m21, p3),
    ], dim=-2)                                          # (..., 4, 4)
    idx = torch.argmax(torch.stack([p0, p1, p2, p3], dim=-1), dim=-1)
    q = torch.gather(qs, -2, idx[..., None, None].expand(
        idx.shape + (1, 4))).squeeze(-2)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation vector."""
    w = q[..., 0]
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * libm.atan2(vnorm, w)
    small = vnorm < 1e-6
    vn = torch.where(small, torch.ones_like(vnorm), vnorm)
    factor = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / vn)
    return v * factor[..., None]


def so3_orthonormality_error(R: torch.Tensor) -> torch.Tensor:
    """max |R^T R - I| over a batch of 3x3 matrices (0-d tensor)."""
    I = torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.abs(R.transpose(-1, -2) @ R - I).amax()


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], -1),
    ], dim=-2)


def so3_normalize(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a rotation matrix through its unit quaternion."""
    return mat_from_quat(quat_from_mat(R))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> R^3 via the quaternion route."""
    return quat_log(quat_from_mat(R))


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    th2, small, th, _ = _theta_terms(w)
    W = hat(w)
    W2 = W @ W
    # the library's, as in so3_exp (ROADMAP C15)
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / (th * th))[..., None, None]
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th ** 3))[..., None, None]
    return _eye3_like(W) + b * W + c * W2


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r of SO(3): exp(w + dw) ~ exp(w) exp(J_r dw)."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3), closed form with Taylor fallback."""
    th2, small, ts, ts2 = _theta_terms(w)
    W = hat(-w)
    W2 = W @ W
    coef = torch.where(
        small, 1.0 / 12.0 + th2 / 720.0,
        1.0 / ts2 - (1.0 + libm.cos(ts)) / (2.0 * ts * libm.sin(ts)),
    )[..., None, None]
    return _eye3_like(W) - 0.5 * W + coef * W2


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def se3_identity(batch_shape: Tuple[int, ...] = (), dtype=torch.float32,
                 device=None) -> SE3:
    """Identity pose(s) on ``device`` (see ``resolve_device``)."""
    dev = resolve_device(device)
    R = torch.eye(3, dtype=dtype, device=dev).expand(
        tuple(batch_shape) + (3, 3)).clone()
    return SE3(R, torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                              device=dev))


def se3_exp(xi: torch.Tensor) -> SE3:
    """Exp map R^6 -> SE(3); xi = [v (translation), w (rotation)]."""
    v, w = xi[..., :3], xi[..., 3:]
    return SE3(so3_exp(w), _mv(so3_left_jacobian(w), v))


def se3_log(T: SE3) -> torch.Tensor:
    """Log map SE(3) -> R^6 = [v, w]."""
    w = so3_log(T.R)
    v = _mv(so3_right_jacobian_inv(-w), T.t)
    return torch.cat([v, w], dim=-1)


def se3_inverse(T: SE3) -> SE3:
    Rt = T.R.transpose(-1, -2)
    return SE3(Rt, -_mv(Rt, T.t))


def se3_compose(A: SE3, B: SE3) -> SE3:
    """(A*B)(x) = A(B(x))."""
    return SE3(A.R @ B.R, _mv(A.R, B.t) + A.t)


def se3_apply(T: SE3, x: torch.Tensor) -> torch.Tensor:
    """Transform points x: (..., 3)."""
    return _mv(T.R, x) + T.t


def se3_boxplus(T: SE3, xi: torch.Tensor) -> SE3:
    """Left-multiplicative update exp(xi) * T (the solvers' retraction)."""
    return se3_compose(se3_exp(xi), T)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------


def sim3_identity(batch_shape: Tuple[int, ...] = (), dtype=torch.float32,
                  device=None) -> Sim3:
    dev = resolve_device(device)
    shape = tuple(batch_shape)
    return Sim3(torch.ones(shape, dtype=dtype, device=dev),
                torch.eye(3, dtype=dtype, device=dev).expand(
                    shape + (3, 3)).clone(),
                torch.zeros(shape + (3,), dtype=dtype, device=dev))


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) 'W' matrix coupling translation with rotation and scale:
    W = A Wx + B Wx^2 + C I, each coefficient with its Taylor limits for
    small theta and small sigma (reference lie.py::_sim3_W)."""
    th2_raw, small_th, th_s, th2 = _theta_terms(w)
    Wx = hat(w)
    Wx2 = Wx @ Wx
    s = libm.exp(sigma)
    one = torch.ones_like(sigma)

    small_sig = torch.abs(sigma) < 1e-5
    sig_s = torch.where(small_sig, one, sigma)
    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_s)
    sig2 = sig_s * sig_s
    denom = sig2 + th2
    sin_t, cos_t = libm.sin(th_s), libm.cos(th_s)

    A_gen = (s * sin_t * sig_s + (1.0 - s * cos_t) * th_s) / (th_s * denom)
    B_gen = (C - ((s * cos_t - 1.0) * sig_s + s * sin_t * th_s) / denom) \
        / th2
    A_sig0 = torch.where(small_th, 0.5 - th2_raw / 24.0, (1.0 - cos_t) / th2)
    B_sig0 = torch.where(small_th, 1.0 / 6.0 - th2_raw / 120.0,
                         (th_s - sin_t) / (th_s ** 3))
    A_th0 = torch.where(small_sig, 0.5 + sigma / 3.0,
                        ((sig_s - 1.0) * s + 1.0) / sig2)
    B_th0 = torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0,
                        (s * (0.5 * sig2 - sig_s + 1.0) - 1.0)
                        / (sig2 * sig_s))
    A = torch.where(small_th, A_th0, torch.where(small_sig, A_sig0, A_gen))
    B = torch.where(small_th, B_th0, torch.where(small_sig, B_sig0, B_gen))
    return (A[..., None, None] * Wx + B[..., None, None] * Wx2
            + C[..., None, None] * _eye3_like(Wx))


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """Exp map R^7 -> Sim(3); xi = [v, w, sigma] (g2o::Sim3 semantics)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return Sim3(libm.exp(sigma), so3_exp(w), _mv(_sim3_W(w, sigma), v))


def sim3_log(S: Sim3) -> torch.Tensor:
    """Log map Sim(3) -> R^7 = [v, w, sigma]."""
    sigma = libm.log(S.s)
    w = so3_log(S.R)
    v = torch.linalg.solve(_sim3_W(w, sigma), S.t.unsqueeze(-1)).squeeze(-1)
    return torch.cat([v, w, sigma[..., None]], dim=-1)


def sim3_inverse(S: Sim3) -> Sim3:
    Rt = S.R.transpose(-1, -2)
    s_inv = 1.0 / S.s
    return Sim3(s_inv, Rt, -s_inv[..., None] * _mv(Rt, S.t))


def sim3_compose(A: Sim3, B: Sim3) -> Sim3:
    return Sim3(A.s * B.s, A.R @ B.R, A.s[..., None] * _mv(A.R, B.t) + A.t)


def sim3_apply(S: Sim3, x: torch.Tensor) -> torch.Tensor:
    return S.s[..., None] * _mv(S.R, x) + S.t


def sim3_from_se3(T: SE3, s=None) -> Sim3:
    scale = torch.ones(T.t.shape[:-1], dtype=T.t.dtype,
                       device=T.t.device) if s is None else s
    return Sim3(scale, T.R, T.t)


def se3_from_sim3(S: Sim3) -> SE3:
    """Drop scale: translation divided by scale (the loop-closing
    convention [R t/s; 0 1])."""
    return SE3(S.R, S.t / S.s[..., None])
