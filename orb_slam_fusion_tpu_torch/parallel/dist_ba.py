"""Distributed bundle adjustment: landmark-sharded Schur reduction.

Counterpart of ``orb_slam_fusion_tpu/parallel/dist_ba.py``:

* **Landmarks shard** over the mesh: each shard owns M/D landmarks AND
  their observations (the landmark-major (M, O) tables of
  ``_landmark_major``). Residual and Jacobian evaluation, the 3x3 block
  diagonals, the Schur cross terms, the robust-cost partial sums and the
  back-substitution are local to the shard.
* **Poses replicate**; the reduced camera system
  ``S = Hpp - sum_l W_l Hll_l^-1 W_l^T`` and the robust cost are sums of
  per-landmark contributions, so each LM iteration does one ``psum`` of
  each, and the dense 6K x 6K solve runs once on the mesh's first device.

The two-phase LM (``iters`` robust iterations, a chi2 re-mask,
``iters_second`` plain ones) and its accept rule are the reference's; a
step is taken only if the candidate is finite on EVERY shard. The shards'
partials are added in rank order (``SlamMesh.psum``), so runs repeat to
the bit; against the single-device solver the sums differ in order only.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from .. import cameras, lie
from ..solver.ba import (BAProblem, _eval_factors, _eval_residuals, inv3x3,
                         solve_pos)
from ..solver.robust import CHI2_2D, CHI2_3D, huber_rho, huber_weight
from .mesh import SlamMesh, make_slam_mesh  # noqa: F401  (reference name)


def _landmark_major(prob: BAProblem):
    """Gather the flat factor arrays into landmark-major (M, O) tables.

    Every factor that survives the ``lm_factor_idx`` grouping (within the
    per-landmark ``max_obs`` cap) appears in exactly one (landmark, slot)
    cell, so sharding the landmark axis shards the factor set."""
    F = prob.kf_idx.shape[0]
    fidx = torch.clamp(prob.lm_factor_idx.long(), 0, max(F - 1, 0))
    val = prob.lm_factor_valid & prob.valid[fidx]
    kf_of = torch.where(val, prob.kf_idx[fidx].to(torch.int32),
                        torch.zeros_like(fidx, dtype=torch.int32))
    uv = prob.uv[fidx]
    isig = torch.where(val, prob.inv_sigma2[fidx],
                       torch.zeros((), dtype=prob.inv_sigma2.dtype,
                                   device=fidx.device))
    if prob.stereo_mask is not None and prob.stereo_mask.shape[0] == F:
        ur = prob.u_right[fidx]
        sm = prob.stereo_mask[fidx] & val
    else:
        ur = torch.zeros_like(isig)
        sm = torch.zeros_like(val)
    return kf_of, uv, isig, val, ur, sm


class _Shard(NamedTuple):
    """One shard's local flat factor problem: the landmark grouping is the
    trivial (Ms, O) reshape."""

    loc: BAProblem
    kf: torch.Tensor        # (Ms, O) long
    val: torch.Tensor       # (Ms, O) bool
    th_f: torch.Tensor      # (Ms*O,) per-factor chi2 threshold


def _make_shards(mesh: SlamMesh, points, kf_of, uv, isig, val, ur, sm,
                 fixed_point, fixed_pose, cam_params, bf,
                 chi2_th: float) -> Tuple[List[_Shard], List[torch.Tensor]]:
    """Split the landmark-major tables over the mesh. The padded rows are
    invalid and fixed, so they are inert."""
    dtype = points.dtype
    parts = [mesh.shard(points), mesh.shard(kf_of), mesh.shard(uv),
             mesh.shard(isig), mesh.shard(val, False), mesh.shard(ur),
             mesh.shard(sm, False), mesh.shard(fixed_point, True)]
    shards = []
    for d, dev in enumerate(mesh.devices):
        pts_s, kf_s, uv_s, isig_s, val_s, ur_s, sm_s, fix_s = (
            p[d] for p in parts)
        Ms, O = kf_s.shape

        def flat(x):
            return x.reshape((Ms * O,) + tuple(x.shape[2:]))
        loc = BAProblem(
            poses=None, points=None, kf_idx=flat(kf_s),
            mp_idx=torch.arange(Ms, dtype=torch.int32,
                                device=dev).repeat_interleave(O),
            uv=flat(uv_s), inv_sigma2=flat(isig_s), valid=flat(val_s),
            fixed_pose=fixed_pose.to(dev), fixed_point=fix_s,
            cam_params=cam_params.to(dev),
            lm_factor_idx=torch.arange(Ms * O, dtype=torch.int32,
                                       device=dev).view(Ms, O),
            lm_factor_valid=val_s, u_right=flat(ur_s),
            stereo_mask=flat(sm_s), bf=bf.to(dev))
        # stereo factors are 3-dof: the chi2 threshold scales (reference
        # 7.815 against 5.991, optimizer.cc:118,151)
        th_f = torch.where(
            loc.stereo_mask,
            torch.tensor(chi2_th * CHI2_3D / CHI2_2D, dtype=dtype,
                         device=dev),
            torch.tensor(chi2_th, dtype=dtype, device=dev))
        shards.append(_Shard(loc, kf_s.long(), val_s, th_f))
    return shards, parts[0]


def _shard_cost(poses, points_s, sh: _Shard, inlier, cam_model: str):
    """This shard's robust cost at a state (before the psum)."""
    r, fin = _eval_residuals(poses, points_s, sh.loc, cam_model)
    chi2 = torch.sum(r * r, dim=-1) * sh.loc.inv_sigma2
    act = sh.loc.valid & inlier & fin
    return torch.sum(torch.where(act, huber_rho(chi2, sh.th_f),
                                 torch.zeros_like(chi2)))


def _shard_inlier(poses, points_s, sh: _Shard, cam_model: str):
    """The chi2 outlier re-mask, local to the shard's factors."""
    r, fin = _eval_residuals(poses, points_s, sh.loc, cam_model)
    chi2 = torch.sum(r * r, dim=-1) * sh.loc.inv_sigma2
    return (chi2 <= sh.th_f) & fin & sh.loc.valid


class _Partials(NamedTuple):
    reduced: tuple          # (Hpp (K,6,6), gp (K,6), S (6K,6K), g_corr (K,6))
    W: torch.Tensor         # (Ms, K, 6, 3) pose-landmark blocks
    Hinv: torch.Tensor      # (Ms, 3, 3)
    gl: torch.Tensor        # (Ms, 3)


def _shard_schur(poses, points_s, sh: _Shard, lam, inlier, use_robust: bool,
                 cam_model: str, K: int) -> _Partials:
    """This shard's contributions to the reduced camera system and what
    its back-substitution needs."""
    loc = sh.loc
    dtype, dev = points_s.dtype, points_s.device
    Ms, O = sh.kf.shape
    zero = torch.zeros((), dtype=dtype, device=dev)
    r, Jp, Jl, depth_ok = _eval_factors(poses, points_s, loc, cam_model)
    active = loc.valid & inlier & depth_ok
    chi2 = torch.sum(r * r, dim=-1) * loc.inv_sigma2
    w_rob = (huber_weight(chi2, sh.th_f) if use_robust
             else torch.ones_like(chi2))
    w = torch.where(active, w_rob * loc.inv_sigma2, zero)

    Jpw = Jp * w[:, None, None]
    Jlw = Jl * w[:, None, None]
    Hll_f = torch.einsum("fik,fil->fkl", Jlw, Jl)
    Hpl_f = torch.einsum("fik,fil->fkl", Jpw, Jl)
    gp_f = torch.einsum("fik,fi->fk", Jpw, r)
    gl_f = torch.einsum("fik,fi->fk", Jlw, r)
    # pose-axis reductions over the shard's factors: a one-hot contraction
    # (a matrix product, the same order on every run)
    P_f = (loc.kf_idx.long()[:, None]
           == torch.arange(K, device=dev)[None, :]).to(dtype)
    Hpp = (P_f.T @ torch.einsum("fik,fil->fkl", Jpw, Jp).reshape(-1, 36)
           ).view(K, 6, 6)
    gp = P_f.T @ gp_f

    # landmark elimination (local)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll = Hll_f.view(Ms, O, 3, 3).sum(dim=1)
    gl = gl_f.view(Ms, O, 3).sum(dim=1)
    Hll_d = Hll + lam * Hll * eye3 + 1e-8 * eye3
    fix = loc.fixed_point
    Hll_d = torch.where(fix[:, None, None], eye3, Hll_d)
    gl = torch.where(fix[:, None], zero, gl)
    Hinv = torch.where(fix[:, None, None], zero, inv3x3(Hll_d))

    # Schur cross terms (local), summed per (landmark, pose)
    Wg = torch.where(sh.val[..., None, None], Hpl_f.view(Ms, O, 6, 3), zero)
    rows = torch.arange(Ms, device=dev)[:, None].expand(Ms, O)
    W = torch.zeros((Ms, K, 6, 3), dtype=dtype, device=dev).index_put_(
        (rows, sh.kf), Wg, accumulate=True)
    E = W @ Hinv[:, None]                                      # (Ms,K,6,3)
    E2 = E.permute(1, 2, 0, 3).reshape(K * 6, Ms * 3)
    W2 = W.permute(1, 2, 0, 3).reshape(K * 6, Ms * 3)
    S = -(E2 @ W2.T)
    g_corr = torch.einsum("mkpc,mc->kp", E, gl)
    return _Partials((Hpp, gp, S, g_corr), W, Hinv, gl)


def _add_block_diag(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S (6K x 6K) plus the (K, 6, 6) blocks on its block diagonal."""
    K, b = blocks.shape[0], blocks.shape[1]
    S4 = S.reshape(K, b, K, b).clone()
    ar = torch.arange(K, device=S.device)
    S4[ar, :, ar, :] += blocks
    return S4.reshape(K * b, K * b)


def _back_substitute(part: _Partials, points_s, fix, dx_p):
    back = torch.einsum("mkpc,kp->mc", part.W, dx_p)
    dx_l = (part.Hinv @ (-part.gl - back).unsqueeze(-1)).squeeze(-1)
    dx_l = torch.where(fix[:, None], torch.zeros_like(dx_l), dx_l)
    return points_s + dx_l


def _any_bad(mesh: SlamMesh, shards_pts) -> torch.Tensor:
    """Number of shards holding a non-finite point (the reference's psum
    of per-shard flags)."""
    return mesh.psum([(~torch.isfinite(p)).any().to(torch.int32)
                      for p in shards_pts])


def _dist_lm_run(mesh: SlamMesh, poses: lie.SE3, shards: List[_Shard],
                 pts: List[torch.Tensor], fixed_pose, cam_model: str,
                 iters: int, iters_second: int):
    """The two-phase LM over the shards. Returns (poses, point shards,
    candidate costs)."""
    home = mesh.home
    K = poses.t.shape[0]
    dtype = pts[0].dtype
    fp = fixed_pose.to(home)
    fpv = fp.repeat_interleave(6)
    zero = torch.zeros((), dtype=dtype, device=home)
    poses = lie.SE3(poses.R.to(home), poses.t.to(home))

    def cost_at(ps, pts_, inl):
        reps = mesh.replicate(ps)
        return mesh.psum([_shard_cost(reps[d], pts_[d], shards[d], inl[d],
                                      cam_model)
                          for d in range(mesh.size)])

    def step(ps, pts_, lam, inl, use_robust):
        reps = mesh.replicate(ps)
        lams = mesh.replicate(lam)
        parts = [_shard_schur(reps[d], pts_[d], shards[d], lams[d], inl[d],
                              use_robust, cam_model, K)
                 for d in range(mesh.size)]
        Hpp, gp, S, g_corr = mesh.psum([p.reduced for p in parts])
        # replicated reduced-camera solve, once on the home device
        S = _add_block_diag(S, Hpp)
        g_r = gp - g_corr
        S = torch.where(fpv[:, None] | fpv[None, :], zero, S)
        S = S + torch.diag(fpv.to(dtype))
        g_r = torch.where(fp[:, None], zero, g_r)
        S = S + torch.diag(lam * torch.diagonal(S) + 1e-8)
        dx_p = -solve_pos(S, g_r.reshape(-1)).reshape(K, 6)
        dx_p = torch.where(fp[:, None], zero, dx_p)
        dxs = mesh.replicate(dx_p)
        cand_pts = [_back_substitute(parts[d], pts_[d],
                                     shards[d].loc.fixed_point, dxs[d])
                    for d in range(mesh.size)]
        return lie.se3_boxplus(ps, dx_p), cand_pts

    def run(ps, pts_, inl, n, use_robust):
        costs = []
        lam = torch.full((), 1e-4, dtype=dtype, device=home)
        cost0 = cost_at(ps, pts_, inl)
        for _ in range(n):
            cand_ps, cand_pts = step(ps, pts_, lam, inl, use_robust)
            cost1 = cost_at(cand_ps, cand_pts, inl)
            # points are sharded: all finite on EVERY shard
            finite = (torch.isfinite(cand_ps.t).all()
                      & (_any_bad(mesh, cand_pts) == 0)
                      & torch.isfinite(cost1))
            accept = (cost1 < cost0) & finite
            ps = lie.SE3(torch.where(accept, cand_ps.R, ps.R),
                         torch.where(accept, cand_ps.t, ps.t))
            accs = mesh.replicate(accept)
            pts_ = [torch.where(accs[d], cand_pts[d], pts_[d])
                    for d in range(mesh.size)]
            lam = torch.where(accept,
                              torch.clamp(lam * (1.0 / 3.0), min=1e-8),
                              torch.clamp(lam * 4.0, max=1e6))
            cost0 = torch.where(accept, cost1, cost0)
            costs.append(cost1)
        return ps, pts_, costs

    inl0 = [torch.ones_like(sh.loc.valid) for sh in shards]
    poses, pts, costs1 = run(poses, pts, inl0, iters, True)
    if iters_second == 0:
        return poses, pts, costs1
    # chi2 outlier re-mask (local: each shard re-masks its factors)
    reps = mesh.replicate(poses)
    inl1 = [_shard_inlier(reps[d], pts[d], shards[d], cam_model)
            for d in range(mesh.size)]
    # phase 1: plain Gauss-Newton weights, trust region restarted
    poses, pts, costs2 = run(poses, pts, inl1, iters_second, False)
    return poses, pts, costs1 + costs2


def distributed_bundle_adjustment(
    prob: BAProblem,
    mesh: SlamMesh,
    cam_model: str = cameras.PINHOLE,
    iters: int = 10,
    iters_second: int = 0,
    chi2_th: float = CHI2_2D,
) -> Tuple[lie.SE3, torch.Tensor, torch.Tensor]:
    """Distributed two-phase LM: ``iters`` robust iterations, then (when
    ``iters_second`` > 0) a chi2 re-mask and ``iters_second`` non-robust
    iterations. Returns (poses, points, costs) on the mesh's first device.

    Pads the landmark axis to the mesh size; the padded rows are fixed and
    invalid, so they are inert. Factors beyond the landmark grouping's
    ``max_obs`` cap are dropped, as the reference drops them.
    """
    M = prob.points.shape[0]
    kf_of, uv, isig, val, ur, sm = _landmark_major(prob)
    bf = (prob.bf if prob.bf is not None
          else torch.zeros((), dtype=torch.float32,
                           device=prob.points.device))
    shards, pts = _make_shards(mesh, prob.points, kf_of, uv, isig, val, ur,
                               sm, prob.fixed_point, prob.fixed_pose,
                               prob.cam_params, bf, chi2_th)
    poses, pts, costs = _dist_lm_run(mesh, prob.poses, shards, pts,
                                     prob.fixed_pose, cam_model, iters,
                                     iters_second)
    return poses, mesh.gather(pts)[:M], torch.stack(costs)
