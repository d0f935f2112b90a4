"""Inertial residuals (forward and backward 9-dim preintegration factors).

Counterpart of ``orb_slam_fusion_tpu/imu/factors.py`` (reference
EdgeInertial::computeError): the residual [r_dR, r_dV, r_dP] between two
(pose, velocity, bias) states through a Preintegrated measurement with the
first-order bias correction. States are body frame: R_wb, p_w, v_w. Every
function broadcasts over leading batch axes (a batch of factors) and is
written without in-place writes, so ``torch.func.jacfwd`` differentiates
it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import lie
from .preintegration import (ImuBias, Preintegrated, bias_corrected_delta,
                             bias_corrected_delta_backward)


def _mv(A, x):
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _T(R):
    return R.transpose(-1, -2)


def inertial_residual(pre: Preintegrated, R_i, p_i, v_i, R_j, p_j, v_j,
                      bias: ImuBias, g_w: torch.Tensor) -> torch.Tensor:
    """(..., 9) residual [er, ev, ep]; zero for a consistent state."""
    dR, dV, dP = bias_corrected_delta(pre, bias)
    dt = pre.dT[..., None]
    er = lie.so3_log(_T(dR) @ _T(R_i) @ R_j)
    ev = _mv(_T(R_i), v_j - v_i - g_w * dt) - dV
    ep = _mv(_T(R_i), p_j - p_i - v_i * dt - 0.5 * g_w * dt * dt) - dP
    return torch.cat([er, ev, ep], dim=-1)


def inertial_residual_backward(pre_bwd: Preintegrated, R_i, p_i, v_i, R_j,
                               p_j, v_j, bias: ImuBias, g_w: torch.Tensor
                               ) -> torch.Tensor:
    """(..., 9) backward residual: state i constrained from state j
    (``pre_bwd`` from ``preintegrate_backward``)."""
    dR, dV, dP = bias_corrected_delta_backward(pre_bwd, bias)
    dt = pre_bwd.dT[..., None]
    er = lie.so3_log(_T(dR) @ _T(R_j) @ R_i)
    ev = _mv(_T(R_j), v_i - v_j + g_w * dt) - dV
    ep = _mv(_T(R_j), p_i - p_j + v_j * dt - 0.5 * g_w * dt * dt) + dP
    return torch.cat([er, ev, ep], dim=-1)


def information_from_cov(pre: Preintegrated, eps: float = 1e-8,
                         max_info: float = 1e6) -> torch.Tensor:
    """(..., 9, 9) information: the inverse of the [phi, v, p] covariance
    block, symmetrized, jittered and spectrum-capped so its largest
    diagonal is at most ``max_info`` (the float32 normal equations could
    not hold a tactical IMU's ~1e8 next to ~1e2 visual blocks)."""
    C = pre.cov[..., :9, :9]
    eye = torch.eye(9, dtype=C.dtype, device=C.device)
    C = 0.5 * (C + _T(C)) + eps * eye
    info = torch.linalg.inv(C)
    dmax = torch.diagonal(info, dim1=-2, dim2=-1).amax(dim=-1)
    # a tensor numerator: a Python scalar over a tensor is a reciprocal
    # times the scalar in torch, one more rounding than the reference's
    scale = torch.clamp(torch.full_like(dmax, max_info)
                        / torch.clamp(dmax, min=1.0), max=1.0)
    return info * scale[..., None, None]


def bias_walk_residual(bias_i: ImuBias, bias_j: ImuBias
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random-walk residuals between consecutive keyframe biases
    (reference EdgeGyroRW / EdgeAccRW)."""
    return bias_j.gyro - bias_i.gyro, bias_j.acc - bias_i.acc
