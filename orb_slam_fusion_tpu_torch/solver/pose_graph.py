"""Pose-graph optimization over Sim(3), with the 4-DoF inertial mode.

Counterpart of ``orb_slam_fusion_tpu/solver/pose_graph.py`` (the
reference's OptimizeEssentialGraph and its 4-DoF variant): every edge's
7-dim Sim3 log residual and its 7x14 Jacobian are evaluated at once, the
Jacobian by forward-mode differentiation of the residuals with one shared
14-dim perturbation (each edge reads only its own copy, so the tangent of
edge e is its own Jacobian), assembled into a dense (7K x 7K)
Gauss-Newton system and solved by Cholesky, with LM damping and monotone
acceptance.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd

from .. import lie
from .ba import solve_pos


class PoseGraphProblem(NamedTuple):
    """poses: Sim3 batch (K,); edge_i/edge_j (E,) int; edge_rel: Sim3
    batch (E,), residual Log(S_rel S_i S_j^-1); edge_weight (E,);
    edge_valid (E,) bool; fixed (K,) bool."""

    poses: lie.Sim3
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_rel: lie.Sim3
    edge_weight: torch.Tensor
    edge_valid: torch.Tensor
    fixed: torch.Tensor


def _edge_residual(rel: lie.Sim3, Si: lie.Sim3, Sj: lie.Sim3,
                   xi_i: torch.Tensor, xi_j: torch.Tensor,
                   right: bool = False) -> torch.Tensor:
    """7-dim residuals with tangent perturbations: left-multiplicative
    (camera side) by default, right (world side) for the 4-DoF mode,
    whose yaw axis is the world's gravity axis."""
    if right:
        Si_p = lie.sim3_compose(Si, lie.sim3_exp(xi_i))
        Sj_p = lie.sim3_compose(Sj, lie.sim3_exp(xi_j))
    else:
        Si_p = lie.sim3_compose(lie.sim3_exp(xi_i), Si)
        Sj_p = lie.sim3_compose(lie.sim3_exp(xi_j), Sj)
    err = lie.sim3_compose(rel, lie.sim3_compose(Si_p,
                                                 lie.sim3_inverse(Sj_p)))
    return lie.sim3_log(err)


# tangent [v(3), w(3), sigma]: the 4-DoF mode keeps translation and yaw
# about the world z (gravity) axis
_MASK_4DOF = (1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0)


def _take(S: lie.Sim3, idx: torch.Tensor) -> lie.Sim3:
    idx = idx.long()
    return lie.Sim3(S.s[idx], S.R[idx], S.t[idx])


def _where(c, a: lie.Sim3, b: lie.Sim3) -> lie.Sim3:
    return lie.Sim3(torch.where(c, a.s, b.s), torch.where(c, a.R, b.R),
                    torch.where(c, a.t, b.t))


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20,
                        four_dof: bool = False
                        ) -> Tuple[lie.Sim3, torch.Tensor]:
    """Gauss-Newton pose-graph optimization. Returns (poses, costs)."""
    K = prob.poses.s.shape[0]
    dtype, dev = prob.poses.t.dtype, prob.poses.t.device
    dof_mask = (torch.tensor(_MASK_4DOF, dtype=dtype, device=dev)
                if four_dof else torch.ones(7, dtype=dtype, device=dev))
    mask14 = torch.cat([dof_mask, dof_mask])
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    w = torch.where(prob.edge_valid, prob.edge_weight,
                    torch.zeros_like(prob.edge_weight)).to(dtype)
    fx = prob.fixed
    zero14 = torch.zeros(14, dtype=dtype, device=dev)

    def residuals(poses, xi2):
        xi2 = xi2 * mask14
        E = ei.shape[0]
        return _edge_residual(prob.edge_rel, _take(poses, ei),
                              _take(poses, ej), xi2[:7].expand(E, 7),
                              xi2[7:].expand(E, 7), right=four_dof)

    def cost(poses):
        r = residuals(poses, zero14)
        return torch.sum(w * torch.sum(r * r, dim=-1))

    def gn_step(poses, lam):
        r = residuals(poses, zero14)                       # (E,7)
        J = jacfwd(lambda z: residuals(poses, z))(zero14)  # (E,7,14)
        Ji, Jj = J[:, :, :7], J[:, :, 7:]
        Hii = torch.einsum("eri,e,erj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eri,e,erj->eij", Jj, w, Jj)
        Hij = torch.einsum("eri,e,erj->eij", Ji, w, Jj)
        gi = torch.einsum("eri,e,er->ei", Ji, w, r)
        gj = torch.einsum("eri,e,er->ei", Jj, w, r)
        Hd = torch.zeros((K, K, 7, 7), dtype=dtype, device=dev)
        Hd.index_put_((ei, ei), Hii, accumulate=True)
        Hd.index_put_((ej, ej), Hjj, accumulate=True)
        Hd.index_put_((ei, ej), Hij, accumulate=True)
        Hd.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
        g = torch.zeros((K, 7), dtype=dtype, device=dev)
        g.index_put_((ei,), gi, accumulate=True)    # in edge order, as
        g.index_put_((ej,), gj, accumulate=True)    # the blocks above
        eye7 = torch.eye(7, dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        Hd = torch.where(fx[:, None, None, None] | fx[None, :, None, None],
                         zero, Hd)
        ar = torch.arange(K, device=dev)
        Hd[ar, ar] += torch.where(fx[:, None, None], eye7, zero)
        g = torch.where(fx[:, None], zero, g)
        H = Hd.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-8)
        dx = -solve_pos(H, g.reshape(-1)).reshape(K, 7)
        dx = torch.where(fx[:, None], zero, dx) * dof_mask
        if four_dof:
            return lie.sim3_compose(poses, lie.sim3_exp(dx))
        return lie.sim3_compose(lie.sim3_exp(dx), poses)

    poses = prob.poses
    lam = torch.tensor(1e-6, dtype=dtype, device=dev)
    costs = []
    for _ in range(iters):
        c0 = cost(poses)
        cand = gn_step(poses, lam)
        c1 = cost(cand)
        ok = ((c1 < c0) & torch.isfinite(cand.t).all()
              & torch.isfinite(cand.s).all())
        poses = _where(ok, cand, poses)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e5))
        costs.append(c1)
    # renormalize rotations after repeated composition
    poses = lie.Sim3(poses.s, lie.so3_normalize(poses.R), poses.t)
    return poses, torch.stack(costs)
