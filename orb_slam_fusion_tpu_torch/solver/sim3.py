"""Sim3 estimation: batched Horn RANSAC and LM refinement.

Counterpart of ``orb_slam_fusion_tpu/solver/sim3.py`` (the reference's
Sim3Solver and OptimizeSim3). Every RANSAC hypothesis is evaluated in one
batch; the 3-point minimal sets are the reference's Gumbel top-k draws,
taken index-exact through ``utils.prng.sample_minimal_sets``. The SVD's
factors may differ in sign between libraries; ``horn_alignment`` uses
them only in sign-invariant products (U diag(S) V^T and sum(d S)).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd

from .. import cameras, lie
from ..utils import prng
from .robust import huber_rho
from .ba import solve_pos


def horn_alignment(x: torch.Tensor, y: torch.Tensor,
                   fix_scale: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form similarity y ~ s R x + t for point sets (..., N, 3),
    by the SVD of the correlation matrix with the reflection guarded."""
    mx = torch.mean(x, dim=-2, keepdim=True)
    my = torch.mean(y, dim=-2, keepdim=True)
    xc = x - mx
    yc = y - my
    W = torch.einsum("...ni,...nj->...ij", yc, xc)
    U, d, Vt = torch.linalg.svd(W)
    det = torch.linalg.det(U @ Vt)
    S = torch.ones(W.shape[:-2] + (3,), dtype=W.dtype, device=W.device)
    S = torch.cat([S[..., :2], det[..., None]], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    if fix_scale:
        s = torch.ones(W.shape[:-2], dtype=W.dtype, device=W.device)
    else:
        var_x = torch.sum(xc * xc, dim=(-2, -1))
        s = torch.sum(d * S, dim=-1) / torch.clamp(var_x, min=1e-12)
    t = my[..., 0, :] - s[..., None] * lie._mv(R, mx[..., 0, :])
    return s, R, t


class Sim3RansacResult(NamedTuple):
    ok: torch.Tensor
    sim: lie.Sim3            # S_21: maps frame-1 points into frame 2
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor


def _dual_check(s, R, t, x1, x2, valid, uv1, uv2, cam_params, cam_model,
                max_err_px):
    """Inliers reproject within ``max_err_px`` in both keyframes
    (reference Sim3Solver::CheckInliers); batched over leading dims of
    (s, R, t)."""
    S12 = lie.Sim3(s, R, t)
    S21 = lie.sim3_inverse(S12)
    p2 = lie.sim3_apply(lie.Sim3(S12.s[..., None], S12.R[..., None, :, :],
                                 S12.t[..., None, :]), x1)
    p1 = lie.sim3_apply(lie.Sim3(S21.s[..., None], S21.R[..., None, :, :],
                                 S21.t[..., None, :]), x2)
    e2 = torch.sum((cameras.project(cam_model, cam_params, p2) - uv2) ** 2,
                   dim=-1)
    e1 = torch.sum((cameras.project(cam_model, cam_params, p1) - uv1) ** 2,
                   dim=-1)
    th = max_err_px ** 2
    return (valid & (p1[..., 2] > 0.01) & (p2[..., 2] > 0.01)
            & (e1 < th) & (e2 < th))


def sim3_ransac(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                uv1: torch.Tensor, uv2: torch.Tensor,
                cam_params: torch.Tensor, key, max_err_px: float = 10.0,
                n_hyp: int = 128, fix_scale: bool = False,
                min_inliers: int = 20, cam_model: str = cameras.PINHOLE
                ) -> Sim3RansacResult:
    """Batched 3-point Sim3 RANSAC with the dual reprojection check, then
    a refit on the best hypothesis' inliers (non-inliers replaced by the
    inlier centroid, as the reference does)."""
    idx = prng.sample_minimal_sets(key, valid, n_hyp, 3)       # (H,3)
    s, R, t = horn_alignment(x1[idx], x2[idx], fix_scale=fix_scale)
    inl = _dual_check(s, R, t, x1, x2, valid, uv1, uv2, cam_params,
                      cam_model, max_err_px)                   # (H,N)
    scores = torch.sum(inl.to(torch.int32), dim=1)
    best = int(torch.argmax(scores))   # first maximum, as jnp.argmax
    m = inl[best]
    w = m.to(x1.dtype)[:, None]
    nw = torch.clamp(torch.sum(w), min=1.0)
    cx = torch.sum(x1 * w, dim=0) / nw
    cy = torch.sum(x2 * w, dim=0) / nw
    x1f = torch.where(m[:, None], x1, cx)
    x2f = torch.where(m[:, None], x2, cy)
    s_f, R_f, t_f = horn_alignment(x1f, x2f, fix_scale=fix_scale)
    inl_f = _dual_check(s_f, R_f, t_f, x1, x2, valid, uv1, uv2, cam_params,
                        cam_model, max_err_px)
    n_in = torch.sum(inl_f.to(torch.int32))
    return Sim3RansacResult(ok=n_in >= min_inliers,
                            sim=lie.Sim3(s_f, R_f, t_f), inliers=inl_f,
                            n_inliers=n_in)


def optimize_sim3(S12: lie.Sim3, x1: torch.Tensor, x2: torch.Tensor,
                  valid: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                  inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
                  cam_params: torch.Tensor, iters: int = 10,
                  fix_scale: bool = False, chi2_th: float = 9.21,
                  cam_model: str = cameras.PINHOLE
                  ) -> Tuple[lie.Sim3, torch.Tensor, torch.Tensor]:
    """LM refinement of S12 with bidirectional reprojection residuals
    (reference OptimizeSim3): x1 through S12 against uv2, x2 through
    S12^-1 against uv1. Returns (refined S12, inlier mask, n_inliers)."""
    dtype, dev = x1.dtype, x1.device

    def residuals(xi):
        # xi as a batch of one: jacfwd gives a 0-d tensor's tangent
        # float64 once a Python scalar meets it
        S = lie.sim3_compose(lie.sim3_exp(xi[None]), S12)
        Sinv = lie.sim3_inverse(S)
        p2 = lie.sim3_apply(S, x1)
        p1 = lie.sim3_apply(Sinv, x2)
        r2 = cameras.project(cam_model, cam_params, p2) - uv2
        r1 = cameras.project(cam_model, cam_params, p1) - uv1
        return r1, r2, p1[..., 2] > 0.01, p2[..., 2] > 0.01

    def flat(xi):
        r1, r2, _, _ = residuals(xi)
        return torch.cat([r1.reshape(-1), r2.reshape(-1)])

    def cost_of(xi, inlier):
        r1, r2, d1, d2 = residuals(xi)
        c1 = torch.sum(r1 * r1, dim=-1) * inv_sigma2_1
        c2 = torch.sum(r2 * r2, dim=-1) * inv_sigma2_2
        act = inlier & valid & d1 & d2
        return torch.sum(torch.where(act, huber_rho(c1, chi2_th)
                                     + huber_rho(c2, chi2_th),
                                     torch.zeros_like(c1)))

    xi = torch.zeros(7, dtype=dtype, device=dev)
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    inlier = valid
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    for _ in range(iters):
        J = jacfwd(flat)(xi)                                # (4N, 7)
        r1, r2, d1, d2 = residuals(xi)
        act = (inlier & valid & d1 & d2).to(dtype)
        w = torch.cat([torch.repeat_interleave(act * inv_sigma2_1, 2),
                       torch.repeat_interleave(act * inv_sigma2_2, 2)])
        r = torch.cat([r1.reshape(-1), r2.reshape(-1)])
        Jw = J * w[:, None]
        H = Jw.T @ J
        g = Jw.T @ r
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            g = torch.cat([g[:6], torch.zeros_like(g[6:])])
        dx = -solve_pos(H + lam * torch.diag(torch.diagonal(H))
                        + 1e-8 * eye7, g)
        c0 = cost_of(xi, inlier)
        c1 = cost_of(xi + dx, inlier)
        ok = (c1 < c0) & torch.isfinite(dx).all()
        xi = torch.where(ok, xi + dx, xi)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-8),
                          torch.clamp(lam * 5.0, max=1e4))

    r1, r2, d1, d2 = residuals(xi)
    c1 = torch.sum(r1 * r1, dim=-1) * inv_sigma2_1
    c2 = torch.sum(r2 * r2, dim=-1) * inv_sigma2_2
    inlier = valid & d1 & d2 & (c1 < chi2_th) & (c2 < chi2_th)
    S_out = lie.sim3_compose(lie.sim3_exp(xi[None]), S12)
    S_out = lie.Sim3(S_out.s[0], S_out.R[0], S_out.t[0])
    return S_out, inlier, torch.sum(inlier.to(torch.int32))
