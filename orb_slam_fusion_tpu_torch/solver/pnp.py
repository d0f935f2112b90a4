"""Absolute pose (PnP): batched 6-point DLT RANSAC and ML refinement.

Counterpart of ``orb_slam_fusion_tpu/solver/pnp.py`` (the reference's
MLPnPsolver role in relocalization): every RANSAC hypothesis is a 6-point
DLT pose from one batched SVD, scored by the dual cheirality and
information-weighted reprojection gate; the winner is refined by the
null-space bearing-vector estimator (``mlpnp_refine``) and a final
pixel-space ``pose_optimization``. The minimal sets are the reference's
Gumbel top-k draws, index-exact (``utils.prng.sample_minimal_sets``).
The DLT's null vector has a sign that SVD libraries choose differently,
and the reference's orthonormalization is right only for one of them; the
port fixes the sign to that one (a positive scale), where the reference
takes what LAPACK returns. The hypotheses are the reference's, and so is
the refined pose, within a tolerance.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import cameras, lie
from ..utils import prng
from ..utils.fused import sum_sq_f32
from .pose_opt import pose_optimization


class PnPResult(NamedTuple):
    ok: torch.Tensor
    pose: lie.SE3            # Tcw
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _proper(Rraw: torch.Tensor):
    """(R, sum(d S)) of U diag(1, 1, det(U V^T)) V^T."""
    U, d, Vt = torch.linalg.svd(Rraw)
    det = torch.linalg.det(U @ Vt)
    S = torch.cat([torch.ones_like(d[..., :2]), det[..., None]], dim=-1)
    return (U * S[..., None, :]) @ Vt, torch.sum(d * S, dim=-1)


def _dlt_pose(X: torch.Tensor, rays: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 6-point DLT for [R|t]; X, rays (H, 6, 3) with rays z = 1.
    Returns (R (H,3,3), t (H,3))."""
    x, y = rays[..., 0], rays[..., 1]
    Xh = torch.cat([X, torch.ones_like(x)[..., None]], dim=-1)   # (H,6,4)
    z4 = torch.zeros_like(Xh)
    rows_a = torch.cat([Xh, z4, -x[..., None] * Xh], dim=-1)
    rows_b = torch.cat([z4, Xh, -y[..., None] * Xh], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)                      # (H,12,12)
    p = torch.linalg.svd(A)[2][..., -1, :]
    P = p.reshape(p.shape[:-1] + (3, 4))
    # the null vector's sign is the SVD library's choice, and the
    # orthonormalization below is right only for the sign that makes
    # det(P[:, :3]) > 0 (a positive scale); fix that sign here so every
    # library (LAPACK on the host, cuSOLVER on the card) gets one pose
    sgn = torch.where(torch.linalg.det(P[..., :3]) < 0, -1.0, 1.0)
    P = P * sgn[..., None, None]
    R, dsum = _proper(P[..., :3])
    scale = dsum / 3.0
    scale = torch.where(torch.abs(scale) < 1e-12,
                        torch.full_like(scale, 1e-12), scale)
    t = P[..., 3] / scale[..., None]
    # overall sign from the first point's cheirality, then back to SO(3)
    z0 = lie._mv(R, X[..., 0, :])[..., 2] + t[..., 2]
    flip = z0 < 0
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    R, _ = _proper(R)
    return R, t


def bearing_nullspace(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tangent-plane basis [r, s] of unit bearings v (N, 3), seeded by the
    coordinate axis least aligned with v (the first on ties)."""
    a = torch.abs(v)
    amin = torch.amin(a, dim=-1, keepdim=True)
    cols = torch.arange(3, device=v.device)
    first = torch.amin(torch.where(a == amin, cols, torch.full_like(cols, 3)),
                       dim=-1)
    e = torch.nn.functional.one_hot(first, 3).to(v.dtype)
    r = torch.linalg.cross(e, v)
    r = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True),
                        min=1e-12)
    return r, torch.linalg.cross(v, r)


def mlpnp_refine(pose0: lie.SE3, X: torch.Tensor, bearings: torch.Tensor,
                 inv_sigma2: torch.Tensor, valid: torch.Tensor,
                 iters: int = 10) -> Tuple[lie.SE3, torch.Tensor]:
    """Null-space bearing-vector ML refinement: minimize
    sum_i w_i |[r_i s_i]^T v_hat_i(T)|^2, v_hat = (RX+t)/|RX+t|, by
    LM-damped Gauss-Newton. Returns (pose, final cost)."""
    dtype, dev = X.dtype, X.device
    v_obs = bearings / torch.clamp(
        torch.linalg.norm(bearings, dim=-1, keepdim=True), min=1e-12)
    rb, sb = bearing_nullspace(v_obs)
    w = torch.where(valid, inv_sigma2, torch.zeros_like(inv_sigma2)
                    ).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    B = torch.stack([rb, sb], dim=-2)                        # (N,2,3)

    def res_jac(pose):
        pc = lie.se3_apply(pose, X)
        nrm = torch.clamp(torch.linalg.norm(pc, dim=-1, keepdim=True),
                          min=1e-9)
        vh = pc / nrm
        r = torch.stack([torch.sum(rb * vh, -1), torch.sum(sb * vh, -1)],
                        dim=-1)                              # (N,2)
        P = (eye3 - vh[..., :, None] * vh[..., None, :]) / nrm[..., None]
        Jpc = torch.cat([eye3.expand(pc.shape[:-1] + (3, 3)),
                         -lie.hat(pc)], dim=-1)              # (N,3,6)
        J = B @ P @ Jpc                                      # (N,2,6)
        fin = torch.isfinite(r).all(-1) & torch.isfinite(J).flatten(1).all(-1)
        z = torch.zeros((), dtype=dtype, device=dev)
        return (torch.where(fin[..., None], r, z),
                torch.where(fin[..., None, None], J, z))

    def cost_of(pose):
        r, _ = res_jac(pose)
        return torch.sum(w * torch.sum(r * r, -1))

    pose = pose0
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    c0 = cost_of(pose0)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    for _ in range(iters):
        r, J = res_jac(pose)
        H = torch.einsum("nik,n,nil->kl", J, w, J)
        g = torch.einsum("nik,n,ni->k", J, w, r)
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eye6
        dx = -torch.linalg.solve(Hd, g)
        cand = lie.se3_boxplus(pose, dx)
        c1 = cost_of(cand)
        ok = (c1 < c0) & torch.isfinite(c1)
        pose = lie.SE3(torch.where(ok, cand.R, pose.R),
                       torch.where(ok, cand.t, pose.t))
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e5))
        c0 = torch.where(ok, c1, c0)
    return pose, c0


def pnp_ransac(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               cam_params: torch.Tensor, key, max_err_px: float = 5.99,
               n_hyp: int = 256, min_inliers: int = 15,
               cam_model: str = cameras.PINHOLE, inv_sigma2=None,
               ml_refine: bool = True) -> PnPResult:
    """PnP RANSAC over (N,3) world points and (N,2) observations;
    ``inv_sigma2`` the per-observation information (None: unit), which
    scales the chi2 gate and weights the refinement."""
    n = X.shape[0]
    rays = cameras.unproject(cam_model, cam_params, uv)
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones(n, dtype=X.dtype, device=X.device)
    idx = prng.sample_minimal_sets(key, valid, n_hyp, 6)
    R, t = _dlt_pose(X[idx], rays[idx])
    pc = torch.einsum("hij,nj->hni", R, X) + t[:, None, :]
    pred = cameras.project(cam_model, cam_params, pc)
    err2 = sum_sq_f32(pred - uv[None])
    inl = (valid[None, :] & (pc[..., 2] > 0.05)
           & (err2 * inv_sigma2[None, :] < max_err_px ** 2))
    scores = torch.sum(inl.to(torch.int32), dim=1)
    best = int(torch.argmax(scores))
    pose0 = lie.SE3(R[best], t[best])
    inliers0 = inl[best]
    if ml_refine:
        pose0, _ = mlpnp_refine(pose0, X, rays, inv_sigma2, inliers0)
    pose, inliers, n_in = pose_optimization(
        pose0, X, uv, inv_sigma2, inliers0, cam_params,
        cam_model=cam_model, rounds=2)
    return PnPResult(ok=n_in >= min_inliers, pose=pose, inliers=inliers,
                     n_inliers=n_in)
