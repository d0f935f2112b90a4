"""Distributed pose-graph optimization: edge-sharded Gauss-Newton.

Counterpart of ``orb_slam_fusion_tpu/parallel/dist_pose_graph.py``:

* **Edges shard** over the mesh: each shard evaluates its E/D 7-dim Sim3
  residuals and (7 x 14) Jacobians (forward-mode, one shared 14-dim
  perturbation, as ``solver/pose_graph.py``) and scatters its partial
  (K, K, 7, 7) Hessian and (K, 7) gradient, in edge order through
  accumulating ``index_put_`` (ROADMAP H5);
* **Poses replicate**: the partials are added in rank order and the dense
  (7K x 7K) system is solved once on the mesh's first device.

``four_dof`` is the inertial mode (translation and yaw, right-multiplied
perturbations), as in the single-device optimizer.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd

from .. import lie
from ..solver.ba import solve_pos
from ..solver.pose_graph import (_MASK_4DOF, PoseGraphProblem,
                                 _edge_residual, _take, _where)
from .mesh import SlamMesh


class _EdgeShard:
    def __init__(self, ei, ej, rel, weight, valid):
        self.ei, self.ej = ei.long(), ej.long()
        self.rel = rel
        self.w = torch.where(valid, weight, torch.zeros_like(weight))


def _dist_pg_run(mesh: SlamMesh, prob: PoseGraphProblem, iters: int,
                 four_dof: bool):
    home = mesh.home
    K = prob.poses.s.shape[0]
    dtype = prob.poses.t.dtype
    mask = (torch.tensor(_MASK_4DOF, dtype=dtype) if four_dof
            else torch.ones(7, dtype=dtype))
    mask14 = torch.cat([mask, mask])
    rel = [mesh.shard(x) for x in prob.edge_rel]
    parts = [mesh.shard(prob.edge_i), mesh.shard(prob.edge_j)]
    w_sh = mesh.shard(prob.edge_weight)
    v_sh = mesh.shard(prob.edge_valid, False)
    shards = [_EdgeShard(parts[0][d], parts[1][d],
                         lie.Sim3(*(r[d] for r in rel)), w_sh[d], v_sh[d])
              for d in range(mesh.size)]
    masks = mesh.replicate(mask14)

    def residuals(poses, sh, m14, xi2):
        xi2 = xi2 * m14
        E = sh.ei.shape[0]
        return _edge_residual(sh.rel, _take(poses, sh.ei), _take(poses, sh.ej),
                              xi2[:7].expand(E, 7), xi2[7:].expand(E, 7),
                              right=four_dof)

    def assemble(poses, sh, m14):
        """Partial (Hd, g, cost) over the shard's edges."""
        dev = sh.w.device
        z14 = torch.zeros(14, dtype=dtype, device=dev)
        r = residuals(poses, sh, m14, z14)
        J = jacfwd(lambda z: residuals(poses, sh, m14, z))(z14)   # (E,7,14)
        w = sh.w
        Ji, Jj = J[:, :, :7], J[:, :, 7:]
        Hii = torch.einsum("eri,e,erj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eri,e,erj->eij", Jj, w, Jj)
        Hij = torch.einsum("eri,e,erj->eij", Ji, w, Jj)
        gi = torch.einsum("eri,e,er->ei", Ji, w, r)
        gj = torch.einsum("eri,e,er->ei", Jj, w, r)
        Hd = torch.zeros((K, K, 7, 7), dtype=dtype, device=dev)
        Hd.index_put_((sh.ei, sh.ei), Hii, accumulate=True)
        Hd.index_put_((sh.ej, sh.ej), Hjj, accumulate=True)
        Hd.index_put_((sh.ei, sh.ej), Hij, accumulate=True)
        Hd.index_put_((sh.ej, sh.ei), Hij.transpose(-1, -2), accumulate=True)
        g = torch.zeros((K, 7), dtype=dtype, device=dev)
        g.index_put_((sh.ei,), gi, accumulate=True)
        g.index_put_((sh.ej,), gj, accumulate=True)
        return Hd, g, torch.sum(w * torch.sum(r * r, dim=-1))

    def edge_cost(poses, sh, m14):
        r = residuals(poses, sh, m14,
                      torch.zeros(14, dtype=dtype, device=sh.w.device))
        return torch.sum(sh.w * torch.sum(r * r, dim=-1))

    fx = prob.fixed.to(home)
    dof_mask = mask.to(home)
    eye7 = torch.eye(7, dtype=dtype, device=home)
    zero = torch.zeros((), dtype=dtype, device=home)
    ar = torch.arange(K, device=home)
    poses = lie.Sim3(*(x.to(home) for x in prob.poses))
    lam = torch.tensor(1e-6, dtype=dtype, device=home)
    costs = []
    for _ in range(iters):
        reps = mesh.replicate(poses)
        Hd, g, c0 = mesh.psum([assemble(reps[d], shards[d], masks[d])
                               for d in range(mesh.size)])
        Hd = torch.where(fx[:, None, None, None] | fx[None, :, None, None],
                         zero, Hd)
        Hd[ar, ar] += torch.where(fx[:, None, None], eye7, zero)
        g = torch.where(fx[:, None], zero, g)
        H = Hd.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-8)
        dx = -solve_pos(H, g.reshape(-1)).reshape(K, 7)
        dx = torch.where(fx[:, None], zero, dx) * dof_mask
        if four_dof:
            cand = lie.sim3_compose(poses, lie.sim3_exp(dx))
        else:
            cand = lie.sim3_compose(lie.sim3_exp(dx), poses)
        reps = mesh.replicate(cand)
        c1 = mesh.psum([edge_cost(reps[d], shards[d], masks[d])
                        for d in range(mesh.size)])
        ok = ((c1 < c0) & torch.isfinite(cand.t).all()
              & torch.isfinite(cand.s).all())
        poses = _where(ok, cand, poses)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e5))
        costs.append(c1)
    poses = lie.Sim3(poses.s, lie.so3_normalize(poses.R), poses.t)
    return poses, torch.stack(costs)


def distributed_pose_graph(prob: PoseGraphProblem, mesh: SlamMesh,
                           iters: int = 20, four_dof: bool = False
                           ) -> Tuple[lie.Sim3, torch.Tensor]:
    """Edge-sharded pose-graph GN over a mesh.

    Pads the edge axis to a multiple of the mesh size (padded edges are
    invalid, with weight 0 and edge 0's relative pose). Returns (poses,
    costs) on the mesh's first device: the single-device
    ``optimize_pose_graph``'s result up to float reduction order.
    """
    D = mesh.size
    E = prob.edge_i.shape[0]
    pad = (-E) % D
    if pad:
        z = torch.zeros(pad, dtype=prob.edge_i.dtype,
                        device=prob.edge_i.device)
        rel = lie.Sim3(*(torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
                         for x in prob.edge_rel))
        prob = prob._replace(
            edge_i=torch.cat([prob.edge_i, z]),
            edge_j=torch.cat([prob.edge_j, z]),
            edge_rel=rel,
            edge_weight=torch.cat([prob.edge_weight, torch.zeros(
                pad, dtype=prob.edge_weight.dtype,
                device=prob.edge_weight.device)]),
            edge_valid=torch.cat([prob.edge_valid, torch.zeros(
                pad, dtype=torch.bool, device=prob.edge_valid.device)]))
    return _dist_pg_run(mesh, prob, iters, four_dof)
