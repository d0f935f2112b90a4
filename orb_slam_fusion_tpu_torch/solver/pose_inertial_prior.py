"""Per-frame pose-inertial solve with a marginalized 15-dim prior.

Counterpart of ``orb_slam_fusion_tpu/solver/pose_inertial_prior.py``
(reference PoseInertialOptimizationLastFrame + Marginalize +
ConstraintPoseImu): the previous frame rides along under the 15-dim prior
the previous call marginalized, the current frame carries the
reprojection factors, an inertial factor joins them, and after the solve
the previous state is Schur-marginalized into the prior carried to the
next frame. As in the reference, the two frames share one 6-dim bias
(the bias walk enters as covariance inflation of the carried prior's bias
block) and the normal equations are Jacobi-preconditioned, both forced by
float32.

Tangent order: [pose_prev (6), vel_prev (3), pose_cur (6), vel_cur (3),
bias_g (3), bias_a (3)]; the marginalized prior covers the last 15.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd

from .. import cameras, lie
from ..imu.preintegration import ImuBias, ImuCalib, Preintegrated, gravity_vec
from .pose_opt import _residual_and_jac
from .ba import solve_pos
from .robust import CHI2_2D, huber_rho, huber_weight
from .vi_ba import _inertial_res


class PoseImuPrior(NamedTuple):
    """Marginalized Gaussian over one frame's [pose, vel, bg, ba]: the
    information ``H`` in the tangent at the stored linearization point."""

    pose: lie.SE3           # camera Tcw linearization point
    vel: torch.Tensor       # (3,)
    bg: torch.Tensor        # (3,)
    ba: torch.Tensor        # (3,)
    H: torch.Tensor         # (15,15)


def make_initial_prior(pose: lie.SE3, vel, bias: ImuBias,
                       pose_info: float = 1e4, vel_info: float = 1e2,
                       bias_info_g: float = 1e4, bias_info_a: float = 1e2
                       ) -> PoseImuPrior:
    """A fresh prior at a keyframe-anchored state."""
    d = torch.tensor([pose_info] * 6 + [vel_info] * 3 + [bias_info_g] * 3
                     + [bias_info_a] * 3, dtype=torch.float32,
                     device=pose.t.device)
    return PoseImuPrior(pose=pose, vel=vel, bg=bias.gyro, ba=bias.acc,
                        H=torch.diag(d))


def inflate_bias_walk(H: torch.Tensor, calib: ImuCalib, dT) -> torch.Tensor:
    """Kalman-predict the bias block, C' = C + E Q E^T in information form
    (Woodbury), Q = diag(sigma_wg^2, sigma_wa^2) * dT."""
    dtype = H.dtype
    dT = torch.clamp(dT, min=1e-6)
    q_g = torch.ones((), dtype=dtype, device=H.device) / (
        calib.walk_gyro ** 2 * dT)
    q_a = torch.ones((), dtype=dtype, device=H.device) / (
        calib.walk_acc ** 2 * dT)
    q_inv = torch.cat([q_g.expand(3), q_a.expand(3)]).to(dtype)
    HE = H[:, 9:15]                              # (15, 6)
    B = torch.diag(q_inv) + H[9:15, 9:15]        # (6, 6)
    Hn = H - HE @ solve_pos(B, HE.T)
    return 0.5 * (Hn + Hn.T)


def _boxminus15(pose, vel, bg, ba, prior: PoseImuPrior) -> torch.Tensor:
    """15-dim tangent residual of a state against the prior's point."""
    dp = lie.se3_log(lie.se3_compose(pose, lie.se3_inverse(prior.pose)))
    return torch.cat([dp, vel - prior.vel, bg - prior.bg, ba - prior.ba],
                     dim=-1)


def _batch1(x):
    """A state (an SE3, a tensor, or a tuple of them) with a leading batch
    axis of one."""
    if isinstance(x, lie.SE3):
        return lie.SE3(x.R[None], x.t[None])
    if isinstance(x, tuple):
        return type(x)(*(_batch1(v) for v in x)) if hasattr(
            x, "_fields") else tuple(_batch1(v) for v in x)
    return x[None]


def pose_inertial_marginalized(
    prior: PoseImuPrior, pose0: lie.SE3, vel0: torch.Tensor,
    pre: Preintegrated, info: torch.Tensor, calib: ImuCalib,
    points_w: torch.Tensor, uv: torch.Tensor, inv_sigma2: torch.Tensor,
    valid: torch.Tensor, cam_params: torch.Tensor,
    cam_model: str = cameras.PINHOLE, rounds: int = 2,
    iters_per_round: int = 3, chi2_th: float = CHI2_2D,
) -> Tuple[lie.SE3, torch.Tensor, ImuBias, PoseImuPrior, torch.Tensor,
           torch.Tensor]:
    """Joint [prev (9) + cur (9) + shared bias (6)] solve, then
    marginalize. Returns (pose, vel, bias, next_prior, inlier (N,),
    n_inliers ())."""
    valid = valid.to(torch.bool)
    dtype, dev = points_w.dtype, points_w.device
    g_w = gravity_vec(dev, dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    H_prior = inflate_bias_walk(prior.H.to(dtype), calib, pre.dT)
    W_blocks = torch.block_diag(H_prior, info.to(dtype))
    z24 = torch.zeros(24, dtype=dtype, device=dev)

    def apply_dx(base, dx):
        pp0, vp0, pc0, vc0, bg0, ba0 = base
        return (lie.se3_boxplus(pp0, dx[..., 0:6]), vp0 + dx[..., 6:9],
                lie.se3_boxplus(pc0, dx[..., 9:15]), vc0 + dx[..., 15:18],
                bg0 + dx[..., 18:21], ba0 + dx[..., 21:24])

    prior1 = _batch1(prior)

    def residuals(dx, base):
        """Prior (15) + inertial (9) residuals at base boxplus dx. The
        state carries a batch axis of one: ``torch.func.jacfwd`` gives a
        float64 tangent to a 0-d tensor combined with a Python scalar."""
        pp, vp, pc_, vc, bg, ba = apply_dx(_batch1(base), dx[None])
        r_prior = _boxminus15(pp, vp, bg, ba, prior1)
        r_inert = _inertial_res(pre, pp, vp, pc_, vc, bg, ba, calib, g_w)
        return torch.cat([r_prior, r_inert], dim=-1)[0]

    def chi2_of(pose):
        r, J, ok = _residual_and_jac(pose, points_w, uv, cam_model,
                                     cam_params)
        return torch.sum(r * r, dim=-1) * inv_sigma2, r, J, ok

    def full_Hg(base, inlier):
        """Gauss-Newton normal equations of the 24-dim joint problem."""
        r0 = residuals(z24, base)
        Jr = jacfwd(residuals)(z24, base)            # (24, 24)
        H = Jr.T @ W_blocks @ Jr
        g = Jr.T @ (W_blocks @ r0)
        chi2, r, J, ok = chi2_of(base[2])
        w = torch.where(inlier & valid & ok,
                        huber_weight(chi2, chi2_th) * inv_sigma2, zero)
        Jw = J * w[:, None, None]
        Hv = torch.einsum("nik,nil->kl", Jw, J)
        gv = torch.einsum("nik,ni->k", Jw, r)
        H = H + torch.nn.functional.pad(Hv, (9, 9, 9, 9))
        g = g + torch.nn.functional.pad(gv, (9, 9))
        return H, g

    def cost_of(base, inlier):
        r0 = residuals(z24, base)
        c = r0 @ W_blocks @ r0
        chi2, _, _, ok = chi2_of(base[2])
        return c + torch.sum(torch.where(inlier & valid & ok,
                                         huber_rho(chi2, chi2_th), zero))

    def select(ok, a, b):
        return tuple(lie.SE3(torch.where(ok, x.R, y.R),
                             torch.where(ok, x.t, y.t))
                     if isinstance(x, lie.SE3) else torch.where(ok, x, y)
                     for x, y in zip(a, b))

    eye24 = torch.eye(24, dtype=dtype, device=dev)
    base = (prior.pose, prior.vel, pose0, vel0, prior.bg, prior.ba)
    inlier = valid
    for _ in range(rounds):
        start = base
        for _ in range(iters_per_round):
            H, g = full_Hg(base, inlier)
            # Jacobi preconditioning: information scales span ~1e2..1e6
            d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
            Hs = H / d[:, None] / d[None, :] + 1e-5 * eye24
            dx = -solve_pos(Hs, g / d) / d
            base = select(torch.isfinite(dx).all(), apply_dx(base, dx), base)
        worse = cost_of(base, inlier) >= cost_of(start, inlier)
        base = select(worse, start, base)
        chi2, _, _, ok = chi2_of(base[2])
        inlier = (chi2 <= chi2_th) & valid & ok

    # marginalize the previous pose+vel block at the solution:
    # H' = Hcc - Hcp Hpp^-1 Hpc, already in [pose_cur, vel_cur, bias] order
    H, _ = full_Hg(base, inlier)
    dd = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hn = H / dd[:, None] / dd[None, :]
    Hpp = Hn[:9, :9] + 1e-6 * eye24[:9, :9]
    Hpc = Hn[:9, 9:]
    Hm = Hn[9:, 9:] - Hpc.T @ solve_pos(Hpp, Hpc)
    H_marg = Hm * dd[9:, None] * dd[None, 9:]
    H_marg = 0.5 * (H_marg + H_marg.T)
    H_marg = torch.where(torch.isfinite(H_marg), H_marg, zero)

    pp, vp, pc_, vc, bg, ba = base
    next_prior = PoseImuPrior(pose=pc_, vel=vc, bg=bg, ba=ba, H=H_marg)
    return (pc_, vc, ImuBias(bg, ba), next_prior, inlier,
            torch.sum(inlier.to(torch.int32)))
