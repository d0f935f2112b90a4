"""Two-view relative-pose initialization via batched RANSAC.

Counterpart of ``orb_slam_fusion_tpu/two_view.py``: all essential (8-point)
and homography (4-point) hypotheses at once as a batch axis, dense Sampson
and transfer-error scoring, the reference's H-vs-E model selection, and
cheirality/parallax checks of every (R, t) decomposition of the winners.

The minimal sets are the reference's own: ``utils.prng`` reproduces
``jax.random``'s bits and its Gumbel top-k selection exactly. The SVDs
are torch's, whose sign conventions may differ from ``jnp.linalg.svd``'s.
A null vector of the other sign scores the same, and sign flips of the
singular vectors only permute the four (or eight) (R, t) candidates, so
the chosen pose is the reference's wherever one candidate scores best;
the tests hold the outputs (``ok``, ``used_homography``, ``inliers``,
``R21``, ``t21``, ``points1``), not the bases.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras
from .utils import prng
from .utils.fused import sum_sq_f32


class TwoViewResult(NamedTuple):
    ok: torch.Tensor          # () bool - initialization succeeded
    R21: torch.Tensor         # (3,3) rotation frame1 -> frame2
    t21: torch.Tensor         # (3,) unit-norm translation
    points1: torch.Tensor     # (N,3) triangulated points in frame-1 coords
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # () int32
    used_homography: torch.Tensor  # () bool


def _null_vectors(A: torch.Tensor) -> torch.Tensor:
    """Right null vector of each (H, 8, 9) system (last row of V^T)."""
    return torch.linalg.svd(A, full_matrices=True)[2][..., -1, :]


def _eight_point(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point essential estimate projected onto the essential
    manifold: (H, 8, 3) rays -> (H, 3, 3)."""
    x1, y1 = r1[..., 0], r1[..., 1]
    x2, y2 = r2[..., 0], r2[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     ones], dim=-1)
    E = _null_vectors(A).reshape(-1, 3, 3)
    u, s, vt2 = torch.linalg.svd(E)
    s_mean = 0.5 * (s[..., 0] + s[..., 1])
    s_fix = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], dim=-1)
    return u @ (s_fix[..., None] * vt2)


def _sampson_error(E: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor
                   ) -> torch.Tensor:
    """Sampson distance per (hypothesis, correspondence): (H, N)."""
    Ex1 = torch.einsum("hij,nj->hni", E, r1)
    Etx2 = torch.einsum("hji,nj->hni", E, r2)
    num = torch.einsum("ni,hni->hn", r2, Ex1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def _decompose_essential(E: torch.Tensor):
    """4 candidate (R, t) pairs from one essential matrix."""
    u, _, vt = torch.linalg.svd(E)
    du = torch.linalg.det(u)
    dv = torch.linalg.det(vt)
    one = torch.ones_like(du)
    u = u * torch.stack([one, one, du])[None, :]
    vt = vt * torch.stack([one, one, dv])[:, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _check_rt(R, t, r1, r2, mask, min_parallax_cos: float = 0.99995):
    """Cheirality + parallax scoring of one (R, t) (reference CheckRT).
    Returns (n_good, points, good mask, representative parallax cos)."""
    X = cameras.triangulate(r1, r2, R, t, exact=False)
    X2 = torch.einsum("ij,nj->ni", R, X) + t
    z1 = X[..., 2]
    z2 = X2[..., 2]
    c1 = X
    c2 = X - (-torch.einsum("ji,j->i", R, t))
    cosp = torch.sum(c1 * c2, dim=-1) / torch.clamp(
        torch.linalg.norm(c1, dim=-1) * torch.linalg.norm(c2, dim=-1),
        min=1e-12)
    good = mask & (z1 > 0) & (z2 > 0) & (cosp < min_parallax_cos)
    e1 = sum_sq_f32(X[..., :2] / torch.clamp(z1[..., None], min=1e-9)
                    - r1[..., :2])
    e2 = sum_sq_f32(X2[..., :2] / torch.clamp(z2[..., None], min=1e-9)
                    - r2[..., :2])
    th = (4.0 / 460.0) ** 2
    good = good & (e1 < th) & (e2 < th)
    n_good = torch.sum(good.to(torch.int32))
    cos_sorted = torch.sort(torch.where(good, cosp,
                                        torch.ones_like(cosp))).values
    rep_idx = torch.clamp(torch.clamp(n_good - 1, max=50), 0,
                          cosp.shape[0] - 1)
    return n_good, X, good, cos_sorted[rep_idx.long()]


def _check_all(Rs, ts, r1, r2, mask):
    out = [_check_rt(R, t, r1, r2, mask) for R, t in zip(Rs, ts)]
    return tuple(torch.stack(v) for v in zip(*out))


def _four_point_h(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Batched 4-point DLT homography: (H,4,3) rays -> (H,3,3)."""
    x1, y1 = r1[..., 0], r1[..., 1]
    x2, y2 = r2[..., 0], r2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2],
                         dim=-1)
    rows_b = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2],
                         dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    return _null_vectors(A).reshape(-1, 3, 3)


def _decompose_homography(Hm: torch.Tensor):
    """Faugeras' 8-motion decomposition of a homography: (Rs (8,3,3),
    ts (8,3) unit-normalized), in the reference's candidate order."""
    U, d, Vt = torch.linalg.svd(Hm)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    d2s = torch.clamp(d2, min=1e-12)
    Rs, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sin_t = (d1 - d3) * (e1 * x1) * (e3 * x3) / d2s
            cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
            Rp = torch.stack([torch.stack([cos_t, zero, -sin_t]),
                              torch.stack([zero, one, zero]),
                              torch.stack([sin_t, zero, cos_t])])
            tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3])
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ tp)
            sin_p = (d1 + d3) * (e1 * x1) * (e3 * x3) / d2s
            cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
            Rn = torch.stack([torch.stack([cos_p, zero, sin_p]),
                              torch.stack([zero, -one, zero]),
                              torch.stack([sin_p, zero, -cos_p])])
            tn = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3])
            Rs.append(s * U @ Rn @ Vt)
            ts.append(U @ tn)
    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    return Rs, ts


def _h_transfer_error(Hm: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor
                      ) -> torch.Tensor:
    """Symmetric transfer error (H, N) for homography hypotheses."""
    def xfer(H, a, b):
        p = torch.einsum("hij,nj->hni", H, a)
        w = p[..., 2:3]
        p = p[..., :2] / torch.where(torch.abs(w) < 1e-12,
                                     torch.full_like(w, 1e-12), w)
        return sum_sq_f32(p - b[None, :, :2])

    return xfer(Hm, r1, r2) + xfer(torch.linalg.inv(Hm), r2, r1)


def two_view_init(rays1: torch.Tensor, rays2: torch.Tensor,
                  valid: torch.Tensor, key, n_hyp: int = 256,
                  px_threshold_focal: float = 460.0,
                  min_inliers: int = 50) -> TwoViewResult:
    """E and H RANSAC + model selection + motion recovery, on the device
    of the rays (``key`` is a ``utils.prng`` key). Geometry in frame-1
    coordinates with unit baseline."""
    kE, kH = prng.split(key)
    thresh = (1.5 / px_threshold_focal) ** 2

    # ---------------- essential hypotheses --------------------------------
    idxE = prng.sample_minimal_sets(kE, valid, n_hyp, 8)
    E = _eight_point(rays1[idxE], rays2[idxE])
    inlE = (_sampson_error(E, rays1, rays2) < thresh) & valid[None, :]
    scoreE = torch.sum(inlE.to(torch.int32), dim=1)
    bestE = torch.argmax(scoreE)
    E_best = E[bestE]
    inliersE = inlE[bestE]

    # ---------------- homography hypotheses -------------------------------
    idxH = prng.sample_minimal_sets(kH, valid, n_hyp, 4)
    Hm = _four_point_h(rays1[idxH], rays2[idxH])
    inlH = (_h_transfer_error(Hm, rays1, rays2) < 2.0 * thresh) \
        & valid[None, :]
    scoreH = torch.sum(inlH.to(torch.int32), dim=1)
    bestH = torch.argmax(scoreH)
    inliersH = inlH[bestH]
    use_h = scoreH[bestH].to(torch.float32) >= 0.95 * scoreE[bestE].to(
        torch.float32)

    # ---------------- motion recovery from E ------------------------------
    Rs, ts = _decompose_essential(E_best)
    scores, Xs, goods, rcos = _check_all(Rs, ts, rays1, rays2, inliersE)
    k_best = torch.argmax(scores)
    sorted_scores = torch.sort(scores).values
    distinct = sorted_scores[-1] > torch.maximum(
        (0.9 * sorted_scores[-1]).to(torch.int32), sorted_scores[-2])

    # ---------------- motion recovery from H ------------------------------
    idx_h32 = prng.sample_minimal_sets(prng.fold_in(kH, 1), inliersH, 1,
                                       32)[0]
    H_refit = _four_point_h(rays1[idx_h32][None], rays2[idx_h32][None])[0]
    Rs_h, ts_h = _decompose_homography(H_refit)
    scores_h, Xs_h, goods_h, rcos_h = _check_all(Rs_h, ts_h, rays1, rays2,
                                                 inliersH)
    kh = torch.argmax(scores_h)

    R21 = torch.where(use_h, Rs_h[kh], Rs[k_best])
    t21 = torch.where(use_h, ts_h[kh], ts[k_best])
    X = torch.where(use_h, Xs_h[kh], Xs[k_best])
    good = torch.where(use_h, goods_h[kh], goods[k_best])
    n_good = torch.where(use_h, scores_h[kh], scores[k_best])
    rep_cos = torch.where(use_h, rcos_h[kh], rcos[k_best])

    tnorm = torch.linalg.norm(t21)
    t21 = t21 / torch.clamp(tnorm, min=1e-12)
    X = X / torch.clamp(tnorm, min=1e-12)
    enough_parallax = rep_cos < 0.99984769515   # cos(1 deg)
    ok = ((n_good >= min_inliers) & (distinct | use_h) & (tnorm > 1e-6)
          & enough_parallax)
    return TwoViewResult(ok=ok, R21=R21, t21=t21, points1=X, inliers=good,
                         n_inliers=n_good.to(torch.int32),
                         used_homography=use_h)
