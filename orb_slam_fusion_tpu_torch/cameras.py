"""Camera models (pinhole, Kannala-Brandt 8, radial-tangential) and
two-view triangulation.

Counterpart of ``orb_slam_fusion_tpu/cameras.py``. Parameter layouts:
pinhole ``[fx, fy, cx, cy]``; Kannala-Brandt 8 (equidistant fisheye)
``[fx, fy, cx, cy, k1, k2, k3, k4]`` with d(theta) = theta + k1 th^3 +
k2 th^5 + k3 th^7 + k4 th^9. Every function broadcasts over leading batch
dimensions and runs on the device of its inputs.

Each expression keeps the reference's operation order, one float32
rounding per operation, which is what the reference's eager calls (the
simulator's projections, the tracker's keypoint undistortion) give on
XLA:CPU, so those come out bit for bit; the arctangent is glibc's
``atan2f`` (``frontend/extractor.py::atan2f``), which XLA:CPU calls.
Inside the reference's compiled programs XLA may contract a product and
a sum into one fused multiply-add, so there the two agree to float32
rounding, except where the port restates the fused order: the two-view
triangulation's Gauss-Newton polish (``triangulate_refine``, ROADMAP
C14a), which gives the reference's bits on the host and the card alike.
"""

from __future__ import annotations

import math

import torch

from .utils import libm
from .utils.fused import contract_f32, fma_f32, solve3_f32
from .utils.libm import atan2 as atan2f

PINHOLE = "pinhole"
KANNALA_BRANDT8 = "kannala_brandt8"

_EPS = 1e-9


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as the reference's weak-typed float32 scalar."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def pinhole_project(params: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (...,3) -> pixels (...,2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    zi = 1.0 / _safe_z(xyz[..., 2])
    u = fx * xyz[..., 0] * zi + cx
    v = fy * xyz[..., 1] * zi + cy
    return torch.stack([u, v], dim=-1)


def pinhole_project_jac(params: torch.Tensor, xyz: torch.Tensor
                        ) -> torch.Tensor:
    """Analytic d(uv)/d(xyz): (..., 2, 3)."""
    fx, fy = params[0], params[1]
    x, y = xyz[..., 0], xyz[..., 1]
    zi = 1.0 / _safe_z(xyz[..., 2])
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    row1 = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) -> bearing rays (...,3) with z=1."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded as XLA's (through float64:
    torch's vectorised CPU sqrt may be off by an ulp)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _kb8_radius(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _sqrt(torch.maximum(x * x + y * y, _f32(_EPS * _EPS, x)))


def _kb8_d(theta, th2, k1, k2, k3, k4):
    return theta * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))


def _kb8_dd(th2, k1, k2, k3, k4):
    return 1.0 + th2 * (3 * k1 + th2 * (5 * k2 + th2 * (7 * k3
                                                        + th2 * 9 * k4)))


def kb8_project(params: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Kannala-Brandt 8 fisheye projection (...,3) -> (...,2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = _kb8_radius(x, y)
    theta = atan2f(r, z)
    th2 = theta * theta
    scale = _kb8_d(theta, th2, k1, k2, k3, k4) / r
    u = fx * scale * x + cx
    v = fy * scale * y + cy
    return torch.stack([u, v], dim=-1)


def kb8_project_jac(params: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Analytic d(uv)/d(xyz) for KB8: (..., 2, 3), finite at pc = 0 (the
    radius is clamped in every division, as the reference's)."""
    fx, fy = params[0], params[1]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = _kb8_radius(x, y)
    theta = atan2f(r, z)
    th2 = theta * theta
    d = _kb8_d(theta, th2, k1, k2, k3, k4)
    dd_dth = _kb8_dd(th2, k1, k2, k3, k4)
    norm2 = r * r + z * z
    dth_dr = z / norm2
    dth_dz = -r / norm2
    dr_dx = x / r
    dr_dy = y / r
    dscale_dr = (dd_dth * dth_dr * r - d) / (r * r)
    dscale_dz = dd_dth * dth_dz / r
    scale = d / r
    row0 = torch.stack([fx * (dscale_dr * dr_dx * x + scale),
                        fx * (dscale_dr * dr_dy * x),
                        fx * dscale_dz * x], dim=-1)
    row1 = torch.stack([fy * (dscale_dr * dr_dx * y),
                        fy * (dscale_dr * dr_dy * y + scale),
                        fy * dscale_dz * y], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor,
                  num_iters: int = 10) -> torch.Tensor:
    """KB8 unprojection to unit-depth rays (z = 1): a fixed count of
    Newton steps on theta, as the reference's ``fori_loop``.

    XLA:CPU compiles that loop's body into one fusion: it hoists ``3 k1``,
    ``5 k2``, ``7 k3`` and ``9 k4`` (reassociating ``th2 * 9 * k4``) and
    contracts every product into the add that follows it, ``d - rd``
    included. The steps outside the loop round once each, and ``tan`` is
    glibc's ``tanf`` (``utils/libm.py``)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    rd = _sqrt(mx * mx + my * my)
    rd = torch.minimum(rd, _f32(math.pi / 2.0, rd))
    c3, c5, c7, c9 = 3 * k1, 5 * k2, 7 * k3, 9 * k4
    one = torch.ones_like(rd)
    th = rd
    for _ in range(num_iters):
        th2 = th * th
        d = fma_f32(th2, fma_f32(th2, fma_f32(th2, fma_f32(
            th2, k4, k3), k2), k1), one)
        dd = fma_f32(th2, fma_f32(th2, fma_f32(th2, fma_f32(
            th2, c9, c7), c5), c3), one)
        th = th - fma_f32(th, d, -rd) / dd
    eps = _f32(_EPS, rd)
    scale = torch.where(rd > eps, libm.tan(th) / torch.maximum(rd, eps),
                        torch.ones_like(rd))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def project(model: str, params: torch.Tensor, xyz: torch.Tensor
            ) -> torch.Tensor:
    if model == PINHOLE:
        return pinhole_project(params, xyz)
    if model == KANNALA_BRANDT8:
        return kb8_project(params, xyz)
    raise ValueError(f"unknown camera model {model!r}")


def project_jac(model: str, params: torch.Tensor, xyz: torch.Tensor
                ) -> torch.Tensor:
    if model == PINHOLE:
        return pinhole_project_jac(params, xyz)
    if model == KANNALA_BRANDT8:
        return kb8_project_jac(params, xyz)
    raise ValueError(f"unknown camera model {model!r}")


def unproject(model: str, params: torch.Tensor, uv: torch.Tensor
              ) -> torch.Tensor:
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    if model == KANNALA_BRANDT8:
        return kb8_unproject(params, uv)
    raise ValueError(f"unknown camera model {model!r}")


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def triangulate_midpoint(ray1: torch.Tensor, ray2: torch.Tensor,
                         R21: torch.Tensor, t21: torch.Tensor,
                         exact: bool = True) -> torch.Tensor:
    """Midpoint triangulation; returns the point in the cam-1 frame.

    ``exact`` rounds as the reference's eager call does on any device:
    XLA:CPU compiles the lone ``R21 ray1`` dot as a chain of fused
    multiply-adds, and each later product, sum and difference rounds on
    its own, the sums over the three coordinates in order. Otherwise the
    products are the library's (``_mv``, ``torch.sum``), which round as
    MKL, cuBLAS and the device's reductions do."""
    o1 = t21.expand(ray1.shape)
    d2 = ray2
    if exact:
        d1 = contract_f32(ray1[..., None, :], R21)
        p = torch.stack([d1 * d1, d1 * d2, d2 * d2, d1 * o1, d2 * o1])
        a, b, c, d, e = ((p[..., 0] + p[..., 1]) + p[..., 2]).unbind(0)
    else:
        d1 = _mv(R21, ray1)
        a = torch.sum(d1 * d1, dim=-1)
        b = torch.sum(d1 * d2, dim=-1)
        c = torch.sum(d2 * d2, dim=-1)
        d = torch.sum(d1 * o1, dim=-1)
        e = torch.sum(d2 * o1, dim=-1)
    denom = a * c - b * b
    denom = torch.where(torch.abs(denom) < _EPS,
                        torch.full_like(denom, _EPS), denom)
    s = (b * e - c * d) / denom
    return s[..., None] * ray1


def triangulate_refine(X0: torch.Tensor, ray1: torch.Tensor,
                       ray2: torch.Tensor, R21: torch.Tensor,
                       t21: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Fixed-count Gauss-Newton polish of the two-view reprojection error.

    The reference's body runs inside ``lax.fori_loop``, one compiled
    program even under an eager caller. XLA:CPU emits its four small dots
    (``R21 X``, ``J2p R21``, ``J^T J``, ``J^T r``) as chains of fused
    multiply-adds and calls LAPACK for the solve; a far point's
    Gauss-Newton steps amplify one rounding of them into a percent of
    depth (ROADMAP C14a). So the dots are ``contract_f32`` chains, the
    six distinct entries of ``J^T J`` and the three of ``J^T r`` stepped
    together, and the solve is ``solve3_f32``."""
    eye3 = torch.eye(3, dtype=X0.dtype, device=X0.device)
    # J^T J's upper triangle (row-major) and J^T r: left and right factors
    hi = torch.tensor([0, 0, 0, 1, 1, 2], device=X0.device)
    hj = torch.tensor([0, 1, 2, 1, 2, 2], device=X0.device)
    full = torch.tensor([0, 1, 2, 1, 3, 4, 2, 4, 5], device=X0.device)
    # +0 starts a dot's chain; -0 makes J^T r's first step the plain
    # product its matrix-vector kernel takes
    zero = torch.tensor([0.0] * 6 + [-0.0] * 3, dtype=X0.dtype,
                        device=X0.device)
    X = X0
    for _ in range(iters):
        z1 = _safe_z(X[..., 2])
        r1 = X[..., :2] / z1[..., None] - ray1[..., :2]
        zi = 1.0 / z1
        zeros = torch.zeros_like(zi)
        J1 = torch.stack([
            torch.stack([zi, zeros, -X[..., 0] * zi * zi], dim=-1),
            torch.stack([zeros, zi, -X[..., 1] * zi * zi], dim=-1),
        ], dim=-2)
        X2 = contract_f32(X[..., None, :], R21) + t21
        z2 = _safe_z(X2[..., 2])
        r2 = X2[..., :2] / z2[..., None] - ray2[..., :2]
        zi2 = 1.0 / z2
        J2p = torch.stack([
            torch.stack([zi2, zeros, -X2[..., 0] * zi2 * zi2], dim=-1),
            torch.stack([zeros, zi2, -X2[..., 1] * zi2 * zi2], dim=-1),
        ], dim=-2)
        J2 = contract_f32(J2p[..., :, None, :], R21.transpose(-1, -2))
        J = torch.cat([J1, J2], dim=-2)                    # (...,4,3)
        r = torch.cat([r1, r2], dim=-1)                    # (...,4)
        Jt = J.transpose(-1, -2)                           # (...,3,4)
        lhs = torch.cat([Jt[..., hi, :], Jt], dim=-2)      # (...,9,4)
        rhs = torch.cat([Jt[..., hj, :],
                         r[..., None, :].expand(Jt.shape)], dim=-2)
        Hg = contract_f32(lhs, rhs, zero)
        H = Hg[..., full].unflatten(-1, (3, 3)) + 1e-9 * eye3
        X = X - solve3_f32(H, Hg[..., 6:])
    return X


def _refine_library(X0: torch.Tensor, ray1: torch.Tensor,
                    ray2: torch.Tensor, R21: torch.Tensor,
                    t21: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """``triangulate_refine`` with library products and solve (MKL on the
    host, cuBLAS and cuSOLVER on the card): each rounds in its own order."""
    eye3 = torch.eye(3, dtype=X0.dtype, device=X0.device)
    X = X0
    for _ in range(iters):
        z1 = _safe_z(X[..., 2])
        r1 = X[..., :2] / z1[..., None] - ray1[..., :2]
        zi = 1.0 / z1
        zeros = torch.zeros_like(zi)
        J1 = torch.stack([
            torch.stack([zi, zeros, -X[..., 0] * zi * zi], dim=-1),
            torch.stack([zeros, zi, -X[..., 1] * zi * zi], dim=-1),
        ], dim=-2)
        X2 = _mv(R21, X) + t21
        z2 = _safe_z(X2[..., 2])
        r2 = X2[..., :2] / z2[..., None] - ray2[..., :2]
        zi2 = 1.0 / z2
        J2p = torch.stack([
            torch.stack([zi2, zeros, -X2[..., 0] * zi2 * zi2], dim=-1),
            torch.stack([zeros, zi2, -X2[..., 1] * zi2 * zi2], dim=-1),
        ], dim=-2)
        J2 = J2p @ R21
        J = torch.cat([J1, J2], dim=-2)                    # (...,4,3)
        r = torch.cat([r1, r2], dim=-1)                    # (...,4)
        H = J.transpose(-1, -2) @ J + 1e-9 * eye3
        g = _mv(J.transpose(-1, -2), r)
        # solve_ex: a singular system (a padded, all-zero ray pair) gives
        # NaN rows where the reference's jnp solve does, instead of raising
        dX, info = torch.linalg.solve_ex(H, g.unsqueeze(-1))
        dX = torch.where((info == 0)[..., None, None], dX,
                         torch.full_like(dX, float("nan")))
        X = X - dX.squeeze(-1)
    return X


def triangulate(ray1: torch.Tensor, ray2: torch.Tensor, R21: torch.Tensor,
                t21: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Default triangulation: midpoint init + Gauss-Newton polish.

    ``exact`` starts and polishes in the reference's rounding
    (``triangulate_midpoint(exact=True)``, ``triangulate_refine``), the
    same bits on the host and the card. The fisheye stereo match needs it:
    its rays are the reference's bit for bit, and a far point's depth
    follows every rounding. The mapping step and the two-view init pass
    ``exact=False`` (library products and solve, ``_refine_library``):
    their relative poses come from the port's own float32 solves (the
    essential matrix's SVD, bundle adjustment), which already differ from
    the reference's in the last bits, so exact arithmetic cannot give the
    reference's points there; it would only move which points land on a
    gate's threshold, at several times the launches on every keyframe
    (ROADMAP C14a)."""
    X0 = triangulate_midpoint(ray1, ray2, R21, t21, exact)
    refine = triangulate_refine if exact else _refine_library
    return refine(X0, ray1, ray2, R21, t21)


def _radtan(dist: torch.Tensor):
    k3 = dist[4] if dist.shape[0] > 4 else 0.0
    return dist[0], dist[1], dist[2], dist[3], k3


def radtan_distort_normalized(dist: torch.Tensor, xy: torch.Tensor
                              ) -> torch.Tensor:
    """Radial-tangential (plumb-bob) distortion of normalized coordinates
    (..., 2); ``dist`` = (k1, k2, p1, p2[, k3])."""
    k1, k2, p1, p2, k3 = _radtan(dist)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(params: torch.Tensor, dist: torch.Tensor,
                     uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Undistort pixel keypoints under the radial-tangential model:
    normalize by K, invert the distortion by ``iters`` fixed-point steps
    (cv::undistortPoints' scheme), re-apply K."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    k1, k2, p1, p2, k3 = _radtan(dist)
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / rad
        y = (yd - dy) / rad
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)
