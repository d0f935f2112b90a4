"""Stereo association: rectified row matching, subpixel SAD refinement and
fisheye-pair triangulation.

Counterpart of ``orb_slam_fusion_tpu/frontend/stereo.py``. Each left
keypoint's right partner is one masked dense Hamming match (row band,
disparity window, octave gate), then the reference's median-distance
outlier filter; ``subpixel_refine`` sweeps an 11x11 SAD window +-5 px along
the matched row and fits a parabola. Discrete decisions read float sums,
so those keep the reference's rounding:

* the row tolerance scales with ``1.2 ** octave``, which XLA rounds as the
  correctly rounded float32 power (computed here in float64);
* each SAD sums its 121 absolute differences in row-major order, one
  float32 rounding per addition, as XLA's CPU reduction does; the same
  order on every device, so the card and the CPU agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import cameras
from .extractor import Features
from .matcher import TH_HIGH, hamming_distance_rows, match_masked
from ..utils import libm


def _f32(v: float) -> float:
    """A Python constant rounded to float32, as the reference's weak-typed
    scalars are (exact in a float32 tensor op)."""
    return float(np.float32(v))



def octave_scale(octave: torch.Tensor, power: int = 1) -> torch.Tensor:
    """float32 ``1.2 ** (power * octave)``, rounded as XLA rounds it
    (glibc's ``powf``: ``utils/libm.py``)."""
    return libm.octave_pow(octave.to(torch.float32) * power)


def stereo_match(featsL: Features, featsR: Features, row_tol: float = 2.0,
                 min_disp: float = 0.1, max_disp: float = 128.0,
                 max_dist: int = TH_HIGH
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match left features to right features along rectified rows.
    Returns (u_right (N,), has_stereo (N,)): the right-image u per left
    feature, -1 where unmatched."""
    uvL, uvR = featsL.uv, featsR.uv
    dv = torch.abs(uvL[:, None, 1] - uvR[None, :, 1])
    tolL = row_tol * octave_scale(featsL.octave)
    row_ok = dv <= tolL[:, None]
    disp = uvL[:, None, 0] - uvR[None, :, 0]
    disp_ok = (disp >= _f32(min_disp)) & (disp <= _f32(max_disp))
    oct_ok = torch.abs(featsL.octave[:, None] - featsR.octave[None, :]) <= 1
    mask = (row_ok & disp_ok & oct_ok
            & featsL.valid[:, None] & featsR.valid[None, :])
    idx, ok = match_masked(featsL.desc, featsR.desc, mask, max_dist=max_dist)
    idx_c = torch.clamp(idx, 0, uvR.shape[0] - 1).long()

    # median-distance outlier filter (reference frame.cc:1008+), with the
    # reference's floor of 15 for clean synthetic descriptors
    dist = hamming_distance_rows(featsL.desc, featsR.desc[idx_c])
    big = torch.where(ok, dist, torch.full_like(dist, 1 << 14))
    n_ok = torch.clamp(torch.sum(ok.to(torch.int32)), min=1)
    med = torch.sort(big).values[torch.clamp(n_ok // 2, 0,
                                             big.shape[0] - 1)]
    th = torch.clamp(_f32(1.5 * 1.4) * med.to(torch.float32),
                     min=15.0)
    ok = ok & (dist.to(torch.float32) < th)
    u_right = torch.where(ok, uvR[idx_c, 0], torch.full_like(uvR[:, 0], -1.0))
    return u_right, ok


def subpixel_refine(imgL: torch.Tensor, imgR: torch.Tensor,
                    uvL: torch.Tensor, u_right: torch.Tensor,
                    ok: torch.Tensor, half_win: int = 5, search: int = 5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subpixel SAD refinement of matched disparities (reference
    Frame::ComputeStereoMatches, frame.cc:940+): an 11x11 centre-normalised
    window around each left keypoint swept +-``search`` px along the matched
    right row on the full-resolution images; the SAD minimum gets a
    parabola fit. Matches whose minimum lands on the sweep's edge or whose
    vertex leaves [-1, 1] are dropped. Returns (u_right_refined, ok)."""
    H, Wimg = imgL.shape
    dev = uvL.device
    imgL = imgL.to(torch.float32)
    imgR = imgR.to(torch.float32)
    W, L = half_win, search
    xL = torch.round(uvL[:, 0]).to(torch.int64)
    yL = torch.round(uvL[:, 1]).to(torch.int64)
    xR0 = torch.round(u_right).to(torch.int64)

    dy = torch.arange(-W, W + 1, device=dev)
    rows = torch.clamp(yL[:, None] + dy[None, :], 0, H - 1)        # (N,11)
    colsL = torch.clamp(xL[:, None] + dy[None, :], 0, Wimg - 1)    # (N,11)
    patchL = imgL[rows[:, :, None], colsL[:, None, :]]            # (N,11,11)
    patchL = patchL - patchL[:, W:W + 1, W:W + 1]

    dxs = torch.arange(-W - L, W + L + 1, device=dev)
    colsR = torch.clamp(xR0[:, None] + dxs[None, :], 0, Wimg - 1)  # (N,21)
    strip = imgR[rows[:, :, None], colsR[:, None, :]]             # (N,11,21)
    sl = (torch.arange(2 * W + 1, device=dev)[None, :]
          + torch.arange(2 * L + 1, device=dev)[:, None])          # (11,11)
    win = strip[:, :, sl].permute(0, 2, 1, 3)            # (N,2L+1,11,11)
    win = win - win[:, :, W:W + 1, W:W + 1]
    diff = torch.abs(win - patchL[:, None]).flatten(2)   # (N,2L+1,121)
    sad = diff[..., 0]
    for k in range(1, diff.shape[-1]):                             # row-major
        sad = sad + diff[..., k]

    best = torch.argmin(sad, dim=1)       # first minimum, as jnp.argmin
    interior = (best > 0) & (best < 2 * L)
    bc = torch.clamp(best, 1, 2 * L - 1)
    s1 = torch.gather(sad, 1, (bc - 1)[:, None])[:, 0]
    s2 = torch.gather(sad, 1, bc[:, None])[:, 0]
    s3 = torch.gather(sad, 1, (bc + 1)[:, None])[:, 0]
    denom = s1 + s3 - 2.0 * s2
    delta = torch.where(denom > _f32(1e-6), (s1 - s3) / (2.0 * denom),
                        torch.zeros_like(denom))
    in_range = (delta >= -1.0) & (delta <= 1.0)
    u_new = (xR0.to(torch.float32) + (bc - L).to(torch.float32)) + delta
    keep = ok & interior & in_range
    return torch.where(keep, u_new, torch.full_like(u_new, -1.0)), keep


def depth_from_disparity(u_left: torch.Tensor, u_right: torch.Tensor,
                         bf: float, has_stereo: torch.Tensor) -> torch.Tensor:
    """z = bf / (uL - uR); -1 where invalid (reference mvDepth)."""
    disp = torch.clamp(u_left - u_right, min=_f32(1e-6))
    # a tensor numerator: a Python scalar over a tensor is a reciprocal
    # and a product in torch, two roundings
    z = torch.full_like(disp, _f32(bf)) / disp
    return torch.where(has_stereo, z, torch.full_like(z, -1.0))


def fisheye_stereo_match(featsL: Features, featsR: Features,
                         cam1: torch.Tensor, cam2: torch.Tensor,
                         R21: torch.Tensor, t21: torch.Tensor,
                         lap1: Tuple[float, float] = (0.0, 1e9),
                         lap2: Tuple[float, float] = (0.0, 1e9),
                         max_dist: int = 50, reproj_sigma: float = 2.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-rectified (KB8 fisheye) stereo: a masked Hamming match inside
    both lapping column ranges, both rays unprojected, triangulated through
    the rig extrinsics (x2 = R21 x1 + t21) and accepted by positive depth
    and the reprojection error in both views, each gated with its own
    keypoint's octave sigma (reference TriangulateMatches).
    Returns (depth (N,) in the left camera, -1 invalid; ok (N,))."""
    kb8 = cameras.KANNALA_BRANDT8
    uL, uR = featsL.uv[:, 0], featsR.uv[:, 0]
    in_lap_L = (uL >= lap1[0]) & (uL <= lap1[1]) & featsL.valid
    in_lap_R = (uR >= lap2[0]) & (uR <= lap2[1]) & featsR.valid
    oct_ok = torch.abs(featsL.octave[:, None] - featsR.octave[None, :]) <= 1
    mask = in_lap_L[:, None] & in_lap_R[None, :] & oct_ok
    idx, ok = match_masked(featsL.desc, featsR.desc, mask, max_dist=max_dist)
    idx_c = torch.clamp(idx, 0, featsR.uv.shape[0] - 1).long()

    raysL = cameras.unproject(kb8, cam1, featsL.uv)
    raysR = cameras.unproject(kb8, cam2, featsR.uv)[idx_c]
    X_L = cameras.triangulate(raysL, raysR, R21, t21)
    z = X_L[..., 2]
    X_R = X_L @ R21.T + t21
    uvL_hat = cameras.project(kb8, cam1, X_L)
    uvR_hat = cameras.project(kb8, cam2, X_R)
    eL = torch.sum((uvL_hat - featsL.uv) ** 2, dim=-1)
    eR = torch.sum((uvR_hat - featsR.uv[idx_c]) ** 2, dim=-1)
    s2 = _f32(reproj_sigma ** 2)
    sig2L = s2 * octave_scale(featsL.octave, 2)
    sig2R = s2 * octave_scale(featsR.octave[idx_c], 2)
    good = (ok & (z > 0.05) & (X_R[..., 2] > 0.05)
            & (eL < _f32(5.991) * sig2L) & (eR < _f32(5.991) * sig2R))
    return torch.where(good, z, torch.full_like(z, -1.0)), good
