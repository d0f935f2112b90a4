"""Distributed visual-inertial bundle adjustment.

Counterpart of ``orb_slam_fusion_tpu/parallel/dist_vi_ba.py``: the
landmark-sharded Schur reduction of ``dist_ba.py`` extended to the 15-dof
inertial state (pose, velocity, gyro and acc bias):

* the VISUAL factors shard by landmark exactly as in ``dist_ba``, with one
  ``psum`` of the reduced (6K x 6K) camera system per LM iteration;
* the INERTIAL chain (preintegration factors, bias random walk, the bias
  prior on the first keyframe) is built once on the mesh's first device
  through ``solver.vi_ba.inertial_system`` (K-1 small factors: sharding
  them would buy nothing);
* the equilibrated (15K x 15K) solve is computed there too and its step
  copied to the shards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import lie
from ..imu.preintegration import ImuCalib, gravity_vec
from ..solver.ba import BAProblem, solve_pos
from ..solver.vi_ba import (InertialFactorBatch, VIState,
                            inertial_cost_terms, inertial_system)
from .dist_ba import (_add_block_diag, _any_bad, _back_substitute,
                      _landmark_major, _make_shards, _shard_cost,
                      _shard_schur)
from .mesh import SlamMesh, tree_to


def _dist_vi_run(mesh: SlamMesh, state: VIState, shards, pts, fixed_pose,
                 fixed_inertial, ifac: InertialFactorBatch, calib: ImuCalib,
                 g_w, cam_model: str, iters: int, bias_rw_info_g: float,
                 bias_rw_info_a: float, bias_prior_info_g: float,
                 bias_prior_info_a: float):
    home = mesh.home
    K = state.poses.t.shape[0]
    D = 15
    dtype = pts[0].dtype
    zero = torch.zeros((), dtype=dtype, device=home)
    state = tree_to(state, home)
    ifac = tree_to(ifac, home)
    calib = tree_to(calib, home)
    g_w = g_w.to(home)
    fx_dim = torch.cat([fixed_pose.to(home, torch.bool)[:, None].expand(K, 6),
                        fixed_inertial.to(home, torch.bool)[:, None]
                        .expand(K, 9)], dim=1)                  # (K,D)
    fx = fx_dim.reshape(-1)
    inl = [torch.ones_like(sh.loc.valid) for sh in shards]
    info = (bias_rw_info_g, bias_rw_info_a, bias_prior_info_g,
            bias_prior_info_a)

    def cost_at(st: VIState, pts_):
        reps = mesh.replicate(st.poses)
        c_vis = mesh.psum([_shard_cost(reps[d], pts_[d], shards[d], inl[d],
                                       cam_model)
                           for d in range(mesh.size)])
        return c_vis + inertial_cost_terms(st, ifac, calib, g_w, *info)

    def step(st: VIState, pts_, lam):
        reps = mesh.replicate(st.poses)
        lams = mesh.replicate(lam)
        parts = [_shard_schur(reps[d], pts_[d], shards[d], lams[d], inl[d],
                              True, cam_model, K)
                 for d in range(mesh.size)]
        Hpp, gp, S_pose, g_corr = mesh.psum([p.reduced for p in parts])
        S_pose = _add_block_diag(S_pose, Hpp)
        g_pose = gp - g_corr

        # replicated (15K) system: visual pose blocks + the inertial chain
        H = torch.zeros(K, D, K, D, dtype=dtype, device=home)
        H[:, :6, :, :6] = S_pose.view(K, 6, K, 6)
        g = torch.zeros(K, D, dtype=dtype, device=home)
        g[:, :6] = g_pose
        H_in, g_in = inertial_system(st, ifac, calib, g_w, *info)
        H = (H + H_in).reshape(K * D, K * D)
        g = (g + g_in).reshape(-1)
        Hm = torch.where(fx[:, None] | fx[None, :], zero, H)
        Hm = Hm + torch.diag(fx.to(dtype))
        g = torch.where(fx, zero, g)
        Hd = Hm + torch.diag(lam * torch.diagonal(Hm) + 1e-7)
        # Jacobi equilibration (IMU information ~1e8 next to visual ~1e2 is
        # beyond a float32 factorization unscaled)
        d = torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12))
        Hs = Hd / d[:, None] / d[None, :]
        dx = -solve_pos(Hs, g / d) / d
        dx = torch.where(fx, zero, dx).view(K, D)
        new_state = VIState(
            lie.se3_boxplus(st.poses, dx[:, :6]), st.vel + dx[:, 6:9],
            st.bg + dx[:, 9:12], st.ba + dx[:, 12:15])
        dxs = mesh.replicate(dx[:, :6].contiguous())
        cand_pts = [_back_substitute(parts[d], pts_[d],
                                     shards[d].loc.fixed_point, dxs[d])
                    for d in range(mesh.size)]
        return new_state, cand_pts

    lam = torch.full((), 1e-4, dtype=dtype, device=home)
    c0 = cost_at(state, pts)
    costs = []
    for _ in range(iters):
        cand_s, cand_p = step(state, pts, lam)
        c1 = cost_at(cand_s, cand_p)
        ok = ((c1 < c0) & torch.isfinite(c1)
              & (_any_bad(mesh, cand_p) == 0)
              & torch.isfinite(cand_s.poses.t).all())
        state = VIState(
            lie.SE3(torch.where(ok, cand_s.poses.R, state.poses.R),
                    torch.where(ok, cand_s.poses.t, state.poses.t)),
            torch.where(ok, cand_s.vel, state.vel),
            torch.where(ok, cand_s.bg, state.bg),
            torch.where(ok, cand_s.ba, state.ba))
        oks = mesh.replicate(ok)
        pts = [torch.where(oks[d], cand_p[d], pts[d])
               for d in range(mesh.size)]
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e6))
        c0 = torch.where(ok, c1, c0)
        costs.append(c1)
    return state, pts, costs


def distributed_visual_inertial_ba(
    state: VIState,
    prob: BAProblem,                 # visual part (poses field ignored)
    ifac: InertialFactorBatch,
    calib: ImuCalib,
    mesh: SlamMesh,
    fixed_pose,
    fixed_inertial=None,
    cam_model: str = "pinhole",
    iters: int = 10,
    chi2_th: float = 5.991,
    bias_rw_info_g: float = 1e4,
    bias_rw_info_a: float = 1e2,
    bias_prior_info_g: float = 1e4,
    bias_prior_info_a: float = 1e2,
    g_w: Optional[torch.Tensor] = None,
) -> Tuple[VIState, torch.Tensor, torch.Tensor]:
    """Landmark-sharded VI-BA over a mesh: the surface of
    ``solver.vi_ba.visual_inertial_ba`` plus the mesh. Returns (state,
    points, candidate costs) on the mesh's first device."""
    M = prob.points.shape[0]
    dev = prob.points.device
    K = state.poses.t.shape[0]
    if g_w is None:
        g_w = gravity_vec(dev, prob.points.dtype)
    fixed_pose = torch.as_tensor(fixed_pose, device=dev).to(torch.bool)
    if fixed_inertial is None:
        fixed_inertial = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed_inertial = torch.as_tensor(fixed_inertial, device=dev).to(
        torch.bool)
    kf_of, uv, isig, val, ur, sm = _landmark_major(prob)
    bf = (prob.bf if prob.bf is not None
          else torch.zeros((), dtype=torch.float32, device=dev))
    shards, pts = _make_shards(mesh, prob.points, kf_of, uv, isig, val, ur,
                               sm, prob.fixed_point, fixed_pose,
                               prob.cam_params, bf, chi2_th)
    st, pts, costs = _dist_vi_run(
        mesh, state, shards, pts, fixed_pose, fixed_inertial, ifac, calib,
        g_w, cam_model, iters, bias_rw_info_g, bias_rw_info_a,
        bias_prior_info_g, bias_prior_info_a)
    return st, mesh.gather(pts)[:M], torch.stack(costs)
