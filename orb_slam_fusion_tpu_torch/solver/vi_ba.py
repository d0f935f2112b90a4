"""Visual-inertial bundle adjustment and IMU initialization.

Counterpart of ``orb_slam_fusion_tpu/solver/vi_ba.py``:

* ``visual_inertial_ba`` (reference LocalInertialBA / FullInertialBA):
  keyframe states (pose, velocity, gyro bias, acc bias) = 15 dof, the
  reprojection factors of a ``make_problem`` layout with their landmarks
  Schur-eliminated, 9-dim preintegration factors between consecutive
  keyframes, bias random-walk factors and a bias prior on the first
  keyframe; LM with Jacobi equilibration of the dense (15K)^2 system.
* ``inertial_init`` (reference InertialOptimization): gravity direction,
  scale, one shared bias and per-keyframe velocities with the poses held
  fixed.

The inertial Jacobians come from ``torch.func.jacfwd`` of the residuals
(written without in-place writes), one forward pass per tangent direction
batched over every factor, as the reference takes them from
``jax.jacfwd``. The inertial normal system, the inertial init's normal
equations and both solvers' damping and scaling are summed in the order
of the reference's compiled programs (``utils/fused.py``), and their
positive-definite solves factor the upper triangle, as the reference's
do (``_solve_upper``); a failed factorization gives NaN, as the
reference's does, so the LM accept test rejects the step. Every decision
stays on the device: a solve makes no host round trip.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd

from .. import lie
from ..imu.factors import inertial_residual
from ..imu.preintegration import (ImuBias, ImuCalib, Preintegrated,
                                  gravity_vec)
from .ba import BAProblem, _eval_factors, inv3x3, solve_pos
from .robust import huber_rho, huber_weight
from ..utils import libm
from ..utils.fused import (contract_f32, fma_f32, gemm4_f32, gemv_f32,
                           loop_dot_f32)


class VIState(NamedTuple):
    poses: lie.SE3          # (K,) Tcw
    vel: torch.Tensor       # (K,3) body velocity in world
    bg: torch.Tensor        # (K,3) gyro bias
    ba: torch.Tensor        # (K,3) acc bias


class InertialFactorBatch(NamedTuple):
    """Preintegration factors between keyframe pairs (usually (k, k+1))."""

    i: torch.Tensor         # (P,) int32
    j: torch.Tensor         # (P,) int32
    pre: Preintegrated      # batched (P, ...)
    info: torch.Tensor      # (P,9,9) information of [phi, v, p]
    valid: torch.Tensor     # (P,) bool
    pre_bwd: Optional[Preintegrated] = None
    info_bwd: Optional[torch.Tensor] = None


def _mv(A, x):
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def body_state(pose_cw: lie.SE3, calib: ImuCalib):
    """Tcw -> (R_wb, p_wb): world-from-body rotation and body position."""
    R_bw = calib.Tbc_R @ pose_cw.R
    t_bw = _mv(calib.Tbc_R, pose_cw.t) + calib.Tbc_t
    R_wb = R_bw.transpose(-1, -2)
    return R_wb, -_mv(R_wb, t_bw)


def _inertial_res(pre, pose_i: lie.SE3, v_i, pose_j: lie.SE3, v_j, bg_i,
                  ba_i, calib: ImuCalib, g_w):
    """The 9-dim residual of factor(s) between camera poses (batched)."""
    R_wi, p_wi = body_state(pose_i, calib)
    R_wj, p_wj = body_state(pose_j, calib)
    return inertial_residual(pre, R_wi, p_wi, v_i, R_wj, p_wj, v_j,
                             ImuBias(bg_i, ba_i), g_w)


def _rows(state: VIState, idx):
    return (lie.SE3(state.poses.R[idx], state.poses.t[idx]), state.vel[idx],
            state.bg[idx], state.ba[idx])


def _solve_upper(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``solve_pos`` on the transposed system, so the Cholesky
    factorization reads the upper triangle of H, as the reference's
    ``jax.scipy.linalg.solve(H, g, assume_a="pos")`` does: its
    ``cho_factor(lower=False)`` factors ``H.mT``. A float32 H summed in
    the reference's order is not symmetric to the bit."""
    return solve_pos(H.mT, g)


def _one_hot(idx: torch.Tensor, K: int, dtype) -> torch.Tensor:
    return (idx.long()[:, None] == torch.arange(
        K, device=idx.device)[None, :]).to(dtype)


def _inertial_blocks(state: VIState, ifac: InertialFactorBatch,
                     calib: ImuCalib, g_w):
    """Each preintegration factor's residual r (P, 9) and its Jacobians
    with respect to the tangents of keyframes i and j, Ji, Jj (P, 9, 15)."""
    P = ifac.i.shape[0]
    dtype, dev = state.poses.t.dtype, state.poses.t.device
    D = 15
    ii, jj = ifac.i.long(), ifac.j.long()
    pi, vi, bgi, bai = _rows(state, ii)
    pj, vj, _, _ = _rows(state, jj)

    def edge_res(dx_i, dx_j):
        return _inertial_res(
            ifac.pre, lie.se3_boxplus(pi, dx_i[:, :6]), vi + dx_i[:, 6:9],
            lie.se3_boxplus(pj, dx_j[:, :6]), vj + dx_j[:, 6:9],
            bgi + dx_i[:, 9:12], bai + dx_i[:, 12:15], calib, g_w)

    # one tangent applied to every factor's own state: factor p's residual
    # sees only its own perturbation, so the Jacobian is per factor
    z = torch.zeros(P, D, dtype=dtype, device=dev)
    z1 = torch.zeros(D, dtype=dtype, device=dev)
    r_in = edge_res(z, z)
    Ji = jacfwd(lambda d: edge_res(d.expand(P, D), z))(z1)      # (P,9,15)
    Jj = jacfwd(lambda d: edge_res(z, d.expand(P, D)))(z1)
    return r_in, Ji, Jj


def _weighted_gram(info: torch.Tensor, A: torch.Tensor, B: torch.Tensor
                   ) -> torch.Tensor:
    """(P, n, m) blocks ``A^T info B`` of (P, 9, 9) informations and
    (P, 9, n), (P, 9, m) Jacobians, as XLA:CPU computes ``einsum("pri,prs,
    psj->pij")``: ``info^T A`` first, then that times ``B``, each entry a
    fused chain over the contracted axis in order."""
    T = contract_f32(info.transpose(1, 2)[:, :, None, :],
                     A.transpose(1, 2)[:, None, :, :])         # (P,9,n)
    return contract_f32(T.transpose(1, 2)[:, :, None, :],
                        B.transpose(1, 2)[:, None, :, :])


def inertial_normal_equations(state: VIState, ifac: InertialFactorBatch,
                              r_in, Ji, Jj, bias_rw_info_g: float,
                              bias_rw_info_a: float,
                              bias_prior_info_g: float,
                              bias_prior_info_a: float):
    """The dense normal system H (K, 15, K, 15), g (K, 15) of the factors'
    residuals and Jacobians, the bias walk between their keyframes and the
    bias prior on keyframe 0, summed as the reference's compiled program
    sums them: the per-factor products in XLA:CPU's order (``gemv_f32``,
    ``_weighted_gram``), then scattered by keyframe index in the
    reference's order (Hii, Hjj, Hij, Hij^T, +Hb, +Hb, -Hb, -Hb, the
    prior; g likewise)."""
    K = state.poses.t.shape[0]
    P = ifac.i.shape[0]
    dtype, dev = state.poses.t.dtype, state.poses.t.device
    D = 15
    ii, jj = ifac.i.long(), ifac.j.long()
    w_in = ifac.valid.to(dtype)
    info = ifac.info * w_in[:, None, None]
    v = gemv_f32(info, r_in)                                   # (P,9)
    gi = gemv_f32(Ji.transpose(1, 2), v)
    gj = gemv_f32(Jj.transpose(1, 2), v)
    Hii = _weighted_gram(info, Ji, Ji)
    Hij = _weighted_gram(info, Ji, Jj)
    Hjj = _weighted_gram(info, Jj, Jj)

    ar = torch.arange(D, device=dev)
    H = torch.zeros(K, D, K, D, dtype=dtype, device=dev)

    def add_blocks(a, b, blocks, rows=ar):
        n = rows.shape[0]
        H.index_put_((a[:, None, None], rows[None, :, None],
                      b[:, None, None], rows[None, None, :]),
                     blocks.reshape(-1, n, n), accumulate=True)

    add_blocks(ii, ii, Hii)
    add_blocks(jj, jj, Hjj)
    add_blocks(ii, jj, Hij)
    add_blocks(jj, ii, Hij.transpose(1, 2))
    g = torch.zeros(K, D, dtype=dtype, device=dev)
    g.index_put_((ii,), gi, accumulate=True)
    g.index_put_((jj,), gj, accumulate=True)

    # bias random-walk edges: +Hb on (i,i), (j,j), -Hb on (i,j), (j,i)
    rw = torch.tensor([bias_rw_info_g] * 3 + [bias_rw_info_a] * 3,
                      dtype=dtype, device=dev)
    db = torch.cat([state.bg[jj] - state.bg[ii],
                    state.ba[jj] - state.ba[ii]], dim=-1)       # (P,6)
    gb = rw[None, :] * db * w_in[:, None]
    Hb = torch.diag(rw)[None] * w_in[:, None, None]             # (P,6,6)
    bias = ar[9:]
    add_blocks(ii, ii, Hb, bias)
    add_blocks(jj, jj, Hb, bias)
    add_blocks(ii, jj, -Hb, bias)
    add_blocks(jj, ii, -Hb, bias)
    g.index_put_((ii[:, None], bias[None, :]), -gb, accumulate=True)
    g.index_put_((jj[:, None], bias[None, :]), gb, accumulate=True)

    # bias prior on the first keyframe: its diagonal, and one fused step
    prior = torch.tensor([bias_prior_info_g] * 3 + [bias_prior_info_a] * 3,
                         dtype=dtype, device=dev)
    H[0, bias, 0, bias] += prior
    g[0, 9:] = fma_f32(prior, torch.cat([state.bg[0], state.ba[0]]),
                       g[0, 9:])
    return H, g


def inertial_system(state: VIState, ifac: InertialFactorBatch,
                    calib: ImuCalib, g_w, bias_rw_info_g: float,
                    bias_rw_info_a: float, bias_prior_info_g: float,
                    bias_prior_info_a: float):
    """The inertial, bias-walk and bias-prior contributions to the dense
    normal system: H (K, 15, K, 15), g (K, 15)."""
    r_in, Ji, Jj = _inertial_blocks(state, ifac, calib, g_w)
    return inertial_normal_equations(
        state, ifac, r_in, Ji, Jj, bias_rw_info_g, bias_rw_info_a,
        bias_prior_info_g, bias_prior_info_a)


def inertial_cost_terms(state: VIState, ifac: InertialFactorBatch,
                        calib: ImuCalib, g_w, bias_rw_info_g: float,
                        bias_rw_info_a: float, bias_prior_info_g: float,
                        bias_prior_info_a: float) -> torch.Tensor:
    """Scalar inertial + bias-walk + bias-prior cost at a state (the
    non-visual half of the VI-BA accept test)."""
    ii, jj = ifac.i.long(), ifac.j.long()
    pi, vi, bgi, bai = _rows(state, ii)
    pj, vj, _, _ = _rows(state, jj)
    ri = _inertial_res(ifac.pre, pi, vi, pj, vj, bgi, bai, calib, g_w)
    zero = torch.zeros((), dtype=ri.dtype, device=ri.device)
    c_in = torch.sum(torch.where(
        ifac.valid, torch.einsum("pi,pij,pj->p", ri, ifac.info, ri), zero))
    dbg = state.bg[jj] - state.bg[ii]
    dba = state.ba[jj] - state.ba[ii]
    c_b = torch.sum(torch.where(
        ifac.valid, bias_rw_info_g * torch.sum(dbg * dbg, dim=-1)
        + bias_rw_info_a * torch.sum(dba * dba, dim=-1), zero))
    c_prior = (bias_prior_info_g * torch.sum(state.bg[0] ** 2)
               + bias_prior_info_a * torch.sum(state.ba[0] ** 2))
    return c_in + c_b + c_prior


def _select_state(ok, a: VIState, b: VIState) -> VIState:
    return VIState(lie.SE3(torch.where(ok, a.poses.R, b.poses.R),
                           torch.where(ok, a.poses.t, b.poses.t)),
                   torch.where(ok, a.vel, b.vel),
                   torch.where(ok, a.bg, b.bg), torch.where(ok, a.ba, b.ba))


def visual_inertial_ba(
    state: VIState,
    prob: BAProblem,                # visual part (poses field ignored)
    ifac: InertialFactorBatch,
    calib: ImuCalib,
    fixed_pose: torch.Tensor,       # (K,) bool: pose frozen (gauge/ring)
    fixed_inertial: Optional[torch.Tensor] = None,  # (K,) bool: vel+bias
    cam_model: str = "pinhole",
    iters: int = 10,
    chi2_th: float = 5.991,
    bias_rw_info_g: float = 1e4,
    bias_rw_info_a: float = 1e2,
    bias_prior_info_g: float = 1e4,
    bias_prior_info_a: float = 1e2,
    use_backward: bool = False,
    g_w: Optional[torch.Tensor] = None,
) -> Tuple[VIState, torch.Tensor, torch.Tensor]:
    """LM over (pose, vel, biases) x K + landmarks (Schur-eliminated).

    Returns (state, points, candidate costs (iters,)). ``use_backward`` is
    the reference's signature: its solve does not read it (the backward
    factors are not wired into the system), and neither does this one.
    """
    del use_backward
    K = state.poses.t.shape[0]
    F = prob.kf_idx.shape[0]
    dtype, dev = prob.points.dtype, prob.points.device
    if g_w is None:
        g_w = gravity_vec(dev, dtype)
    D = 15
    zero = torch.zeros((), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    kf = prob.kf_idx.long()
    P_f = _one_hot(kf, K, dtype)                                  # (F,K)
    fidx = torch.clamp(prob.lm_factor_idx.long(), 0, F - 1)       # (M,O)
    vmf = prob.lm_factor_valid
    # the pose of each landmark slot, as a one-hot over the window
    Pm = ((kf[fidx][..., None] == torch.arange(K, device=dev))
          & vmf[..., None]).to(dtype)                             # (M,O,K)
    fin = (torch.zeros(K, dtype=torch.bool, device=dev)
           if fixed_inertial is None else fixed_inertial.to(torch.bool))
    fx_dim = torch.cat([fixed_pose.to(torch.bool)[:, None].expand(K, 6),
                        fin[:, None].expand(K, 9)], dim=1)        # (K,D)
    fx = fx_dim.reshape(-1)
    fixl = prob.fixed_point

    def perturb(s: VIState, dx) -> VIState:
        return VIState(lie.se3_boxplus(s.poses, dx[:, :6]), s.vel + dx[:, 6:9],
                       s.bg + dx[:, 9:12], s.ba + dx[:, 12:15])

    def total_cost(s: VIState, points):
        r, _, _, dok = _eval_factors(s.poses, points, prob, cam_model)
        chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
        c_vis = torch.sum(torch.where(prob.valid & dok,
                                      huber_rho(chi2, chi2_th), zero))
        return c_vis + inertial_cost_terms(
            s, ifac, calib, g_w, bias_rw_info_g, bias_rw_info_a,
            bias_prior_info_g, bias_prior_info_a)

    def lm_step(s: VIState, points, lam):
        # ---- visual part: landmark elimination (reference ba._lm_step) --
        r, Jp, Jl, dok = _eval_factors(s.poses, points, prob, cam_model)
        active = prob.valid & dok
        chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
        w = torch.where(active, huber_weight(chi2, chi2_th)
                        * prob.inv_sigma2, zero)
        Jpw = Jp * w[:, None, None]
        Jlw = Jl * w[:, None, None]
        Hpp_f = torch.einsum("fik,fil->fkl", Jpw, Jp)
        Hll_f = torch.einsum("fik,fil->fkl", Jlw, Jl)
        Hpl_f = torch.einsum("fik,fil->fkl", Jpw, Jl)             # (F,6,3)
        gp_f = torch.einsum("fik,fi->fk", Jpw, r)
        gl_f = torch.einsum("fik,fi->fk", Jlw, r)
        Hpp = (P_f.T @ Hpp_f.reshape(F, 36)).view(K, 6, 6)
        gp = P_f.T @ gp_f
        Hll = torch.where(vmf[..., None, None], Hll_f[fidx], zero).sum(1)
        gl = torch.where(vmf[..., None], gl_f[fidx], zero).sum(1)

        Hll_d = Hll + lam * Hll * eye3 + 1e-8 * eye3
        Hll_d = torch.where(fixl[:, None, None], eye3, Hll_d)
        gl = torch.where(fixl[:, None], zero, gl)
        Hinv = torch.where(fixl[:, None, None], zero, inv3x3(Hll_d))

        Wg = torch.where(vmf[..., None, None], Hpl_f[fidx], zero)  # (M,O,6,3)
        W = torch.einsum("mok,moij->mkij", Pm, Wg)               # (M,K,6,3)
        E = W @ Hinv[:, None]
        M = points.shape[0]
        E2 = E.permute(1, 2, 0, 3).reshape(K * 6, M * 3)
        W2 = W.permute(1, 2, 0, 3).reshape(K * 6, M * 3)
        S = -(E2 @ W2.T).view(K, 6, K, 6)                        # (K,6,K,6)
        kk = torch.arange(K, device=dev)
        S[kk, :, kk, :] += Hpp
        mp = prob.mp_idx.long()
        corr = torch.einsum("fik,fkl,fl->fi", Hpl_f, Hinv[mp], gl[mp])
        g_pose = gp - P_f.T @ corr

        # ---- full (15K) system: visual pose blocks + inertial terms ----
        H_in, g_in = inertial_system(
            s, ifac, calib, g_w, bias_rw_info_g, bias_rw_info_a,
            bias_prior_info_g, bias_prior_info_a)
        H = torch.zeros(K, D, K, D, dtype=dtype, device=dev)
        H[:, :6, :, :6] = S
        H = (H + H_in).reshape(K * D, K * D)
        g = torch.zeros(K, D, dtype=dtype, device=dev)
        g[:, :6] = g_pose
        g = (g + g_in).reshape(-1)

        # ---- fixed dims, damping, equilibrated solve ---------------------
        # as the reference's compiled program: the damping lam * H_ii +
        # 1e-7 one fused step, the two scalings one division by d_i d_j
        Hm = torch.where(fx[:, None] | fx[None, :], zero, H)
        Hm = Hm + torch.diag(fx.to(dtype))
        g = torch.where(fx, zero, g)
        diag = torch.arange(K * D, device=dev)
        Hm[diag, diag] += fma_f32(lam, torch.diagonal(Hm),
                                  torch.full_like(lam, 1e-7))
        # Jacobi equilibration: IMU information (~1e8) next to visual
        # blocks (~1e2) is beyond a float32 factorization unscaled
        d = torch.sqrt(torch.clamp(torch.diagonal(Hm), min=1e-12))
        Hs = Hm / (d[:, None] * d[None, :])
        dx = -_solve_upper(Hs, g / d) / d
        dx = torch.where(fx, zero, dx).view(K, D)
        new_s = perturb(s, dx)

        # ---- landmark back-substitution -----------------------------------
        back_f = torch.einsum("fki,fk->fi", Hpl_f, dx[kf, :6])
        back = torch.where(vmf[..., None], back_f[fidx], zero).sum(1)
        dx_l = (Hinv @ (-gl - back).unsqueeze(-1)).squeeze(-1)
        dx_l = torch.where(fixl[:, None], zero, dx_l)
        return new_s, points + dx_l

    points = prob.points
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    c0 = total_cost(state, points)
    costs = []
    for _ in range(iters):
        cand_s, cand_p = lm_step(state, points, lam)
        c1 = total_cost(cand_s, cand_p)
        finite = (torch.isfinite(c1) & torch.isfinite(cand_s.poses.t).all()
                  & torch.isfinite(cand_p).all())
        ok = (c1 < c0) & finite
        state = _select_state(ok, cand_s, state)
        points = torch.where(ok, cand_p, points)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e6))
        c0 = torch.where(ok, c1, c0)
        costs.append(c1)
    return state, points, torch.stack(costs)


# ---------------------------------------------------------------------------
# IMU initialization
# ---------------------------------------------------------------------------


def _init_normal_equations(Jb, r, info, prior_vec, theta, lam):
    """The damped normal equations of one ``inertial_init`` iteration as
    the reference's compiled loop sums them: ``info^T J`` per factor
    (fused chains), ``J^T (info J)`` over every factor row (Eigen's
    four chains, ``gemm4_f32``), ``J^T (info r)`` (a tiled gemv, then a
    dot fused into a loop), the bias priors added on the diagonal and
    fused onto the gradient, the damping ``lam * H_ii + 1e-7`` one fused
    step."""
    P, _, n = Jb.shape
    T = contract_f32(info.transpose(1, 2)[:, :, None, :],
                     Jb.transpose(1, 2)[:, None, :, :])          # (P,9,n)
    H = gemm4_f32(T.reshape(P * 9, n).T, Jb.reshape(P * 9, n).T)
    gvec = loop_dot_f32(Jb.reshape(P * 9, n).T,
                        gemv_f32(info, r).reshape(1, P * 9))
    prior = torch.arange(3, 9, device=H.device)
    H[prior, prior] += prior_vec
    gvec[3:9] = fma_f32(prior_vec, theta[3:9], gvec[3:9])
    diag = torch.arange(n, device=H.device)
    H[diag, diag] += fma_f32(lam, torch.diagonal(H),
                             torch.full_like(lam, 1e-7))
    return H, gvec


def inertial_init(
    poses: lie.SE3,            # (K,) Tcw: FIXED visual poses
    ifac: InertialFactorBatch,
    calib: ImuCalib,
    iters: int = 30,
    optimize_scale: bool = True,
    prior_g: float = 1e2,
    prior_a: float = 1e5,
) -> Tuple[torch.Tensor, torch.Tensor, ImuBias, torch.Tensor, torch.Tensor]:
    """Estimate (scale, R_wg gravity rotation, shared bias, velocities)
    with the poses fixed (reference InertialOptimization with VertexGDir
    and VertexScale), zero-mean priors of weight ``prior_g``/``prior_a`` on
    the shared biases. Parameters: [gravity direction (2), log scale (1),
    bg (3), ba (3), velocities (3K)].

    Returns (scale, R_wg, bias, velocities (K,3), candidate costs)."""
    K = poses.t.shape[0]
    dtype, dev = poses.t.dtype, poses.t.device
    g0 = gravity_vec(dev, dtype)
    R_wb, p_wb = body_state(poses, calib)
    ii, jj = ifac.i.long(), ifac.j.long()
    n_par = 9 + 3 * K
    zero = torch.zeros((), dtype=dtype, device=dev)

    def unpack(theta):
        # a batch axis of one: jacfwd gives a float64 tangent to a 0-d
        # tensor combined with a Python scalar
        R_wg = lie.so3_exp(torch.cat([theta[:2], torch.zeros(
            1, dtype=dtype, device=dev)])[None])[0]
        s = (libm.exp(theta[2]) if optimize_scale
             else torch.ones((), dtype=dtype, device=dev))
        return R_wg, s, ImuBias(theta[3:6], theta[6:9]), theta[9:].view(K, 3)

    def residuals(theta):
        R_wg, s, bias, vel = unpack(theta)
        g_w = _mv(R_wg, g0)
        r = inertial_residual(ifac.pre, R_wb[ii], s * p_wb[ii], vel[ii],
                              R_wb[jj], s * p_wb[jj], vel[jj], bias, g_w)
        return torch.where(ifac.valid[:, None], r, zero)

    prior_vec = torch.tensor([prior_g] * 3 + [prior_a] * 3, dtype=dtype,
                             device=dev)

    def cost(theta):
        r = residuals(theta)
        c = torch.sum(torch.einsum("pi,pij,pj->p", r, ifac.info, r))
        return c + torch.sum(prior_vec * theta[3:9] ** 2)

    theta = torch.zeros(n_par, dtype=dtype, device=dev)
    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    costs = []
    for _ in range(iters):
        r = residuals(theta)
        Jb = jacfwd(residuals)(theta)                          # (P,9,n)
        H, gvec = _init_normal_equations(Jb, r, ifac.info, prior_vec,
                                         theta, lam)
        dx = -_solve_upper(H, gvec)
        c0 = cost(theta)
        c1 = cost(theta + dx)
        ok = (c1 < c0) & torch.isfinite(dx).all()
        theta = torch.where(ok, theta + dx, theta)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e6))
        costs.append(c1)
    R_wg, s, bias, vel = unpack(theta)
    return s, R_wg, bias, vel, torch.stack(costs)
