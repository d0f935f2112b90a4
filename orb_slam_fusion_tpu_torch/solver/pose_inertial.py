"""Per-frame pose-inertial optimization with the previous state fixed.

Counterpart of ``orb_slam_fusion_tpu/solver/pose_inertial.py`` (reference
Optimizer::PoseInertialOptimizationLastFrame): a 9-dim Gauss-Newton solve
of the current frame's [pose (6), velocity (3)] against its reprojection
factors (the analytic Jacobian of ``pose_opt``) and the preintegrated IMU
factor from the previous frame, whose state and bias are held. The
inertial Jacobian comes from ``torch.func.jacfwd``; outliers are the
reference's chi-square rounds as mask flips. The sessions use the
marginalized variant (``pose_inertial_prior``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd

from .. import cameras, lie
from ..imu.preintegration import ImuBias, ImuCalib, Preintegrated, gravity_vec
from .pose_opt import _residual_and_jac
from .ba import solve_pos
from .robust import CHI2_2D, huber_rho, huber_weight
from .vi_ba import _inertial_res


def _select(ok, a: lie.SE3, b: lie.SE3) -> lie.SE3:
    return lie.SE3(torch.where(ok, a.R, b.R), torch.where(ok, a.t, b.t))


def pose_inertial_optimization(
    pose0: lie.SE3, vel0: torch.Tensor, prev_pose: lie.SE3,
    prev_vel: torch.Tensor, prev_bias: ImuBias, pre: Preintegrated,
    info: torch.Tensor, calib: ImuCalib, points_w: torch.Tensor,
    uv: torch.Tensor, inv_sigma2: torch.Tensor, valid: torch.Tensor,
    cam_params: torch.Tensor, cam_model: str = cameras.PINHOLE,
    rounds: int = 2, iters_per_round: int = 4, chi2_th: float = CHI2_2D,
) -> Tuple[lie.SE3, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (pose, vel, inlier (N,), n_inliers ())."""
    valid = valid.to(torch.bool)
    dtype, dev = points_w.dtype, points_w.device
    g_w = gravity_vec(dev, dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    eye9 = torch.eye(9, dtype=dtype, device=dev)

    def inertial_r(pose, vel):
        return _inertial_res(pre, prev_pose, prev_vel, pose, vel,
                             prev_bias.gyro, prev_bias.acc, calib, g_w)

    def chi2_of(pose):
        r, J, ok = _residual_and_jac(pose, points_w, uv, cam_model,
                                     cam_params)
        return torch.sum(r * r, dim=-1) * inv_sigma2, r, J, ok

    def cost_of(pose, vel, inlier):
        chi2, _, _, ok = chi2_of(pose)
        c_vis = torch.sum(torch.where(inlier & valid & ok,
                                      huber_rho(chi2, chi2_th), zero))
        ri = inertial_r(pose, vel)
        return c_vis + ri @ info @ ri

    def gn_iters(pose_s, vel_s, inlier):
        pose, vel = pose_s, vel_s
        for _ in range(iters_per_round):
            chi2, r, J, ok = chi2_of(pose)
            w = torch.where(inlier & valid & ok,
                            huber_weight(chi2, chi2_th) * inv_sigma2, zero)
            Jw = J * w[:, None, None]
            Hv = torch.zeros(9, 9, dtype=dtype, device=dev)
            Hv[:6, :6] = torch.einsum("nik,nil->kl", Jw, J)
            gv = torch.zeros(9, dtype=dtype, device=dev)
            gv[:6] = torch.einsum("nik,ni->k", Jw, r)

            pose1 = lie.SE3(pose.R[None], pose.t[None])

            def ri_at(dx):
                # a batch axis of one: jacfwd gives a float64 tangent to a
                # 0-d tensor combined with a Python scalar
                return inertial_r(lie.se3_boxplus(pose1, dx[None, :6]),
                                  vel[None] + dx[None, 6:9])[0]

            z9 = torch.zeros(9, dtype=dtype, device=dev)
            ri = ri_at(z9)
            Ji = jacfwd(ri_at)(z9)
            H = Hv + Ji.T @ info @ Ji
            g = gv + Ji.T @ (info @ ri)
            H = H + 1e-5 * torch.diag(torch.diagonal(H)) + 1e-9 * eye9
            dx = -solve_pos(H, g)
            new_pose = lie.se3_boxplus(pose, dx[:6])
            new_vel = vel + dx[6:9]
            fin = (torch.isfinite(new_pose.t).all()
                   & torch.isfinite(new_pose.R).all()
                   & torch.isfinite(new_vel).all())
            pose = _select(fin, new_pose, pose)
            vel = torch.where(fin, new_vel, vel)
        worse = cost_of(pose, vel, inlier) >= cost_of(pose_s, vel_s, inlier)
        return _select(worse, pose_s, pose), torch.where(worse, vel_s, vel)

    pose, vel, inlier = pose0, vel0, valid
    for _ in range(rounds):
        pose, vel = gn_iters(pose, vel, inlier)
        chi2, _, _, ok = chi2_of(pose)
        inlier = (chi2 <= chi2_th) & valid & ok
    return pose, vel, inlier, torch.sum(inlier.to(torch.int32))
