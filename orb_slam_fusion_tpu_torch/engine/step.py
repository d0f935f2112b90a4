"""Fused per-frame tracking step.

Counterpart of ``orb_slam_fusion_tpu/engine/step.py``: predict -> project
the map through the frustum and scale gates -> coarse match (widened retry
on famine) -> pose solve -> fine re-match -> anchored pose solve ->
visible/found bookkeeping, with no host round trip.

The matching stages of ``fused_frame_update`` call
``frontend.masked_match.masked_match``: the hand-written CUDA kernel on a
CUDA device, its plain version on the CPU.

The widened retry is a ``lax.cond`` on the device in the reference. Here
it is compute-both plus ``torch.where``: the widened match always runs and
is selected when the coarse stage found fewer than ``min_matches``. That
keeps the step free of host syncs, at the cost of one extra match per
frame: **every frame launches the masked-match kernel exactly 3 times**
(coarse, widened, fine).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import cameras, lie
from ..frontend import matcher
from ..frontend.masked_match import masked_match
from ..map.map_state import predict_scale, vec_norm
from ..solver import pose_opt
from ..utils import masked_set
from ..utils import libm

MATCH_LAUNCHES_PER_FRAME = 3


class TrackStepResult(NamedTuple):
    pose: lie.SE3
    inliers: torch.Tensor       # (M,) bool per map point
    n_inliers: torch.Tensor     # () int32
    matched_feat: torch.Tensor  # (M,) int32 feature row per map point or -1


def _visible(pc, uv, mp_valid, img_h, img_w, far_threshold):
    vis = (mp_valid & (pc[..., 2] > 0.05)
           & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
           & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
    if far_threshold > 0:
        vis = vis & (pc[..., 2] < far_threshold)
    return vis


def _invert(midx: torch.Tensor, mok: torch.Tensor, F: int) -> torch.Tensor:
    """Per-map-point matches -> (F,) map-point row per keypoint or -1; the
    largest row wins where several map points chose one keypoint (the
    reference's one-hot masked max)."""
    M = midx.shape[0]
    rows = torch.arange(M, dtype=torch.int32, device=midx.device)
    tgt = torch.where(mok, torch.clamp(midx, 0, F - 1).long(),
                      torch.full_like(midx, F).long())
    out = torch.full((F + 1,), -1, dtype=torch.int32, device=midx.device)
    return out.scatter_reduce(0, tgt, rows, reduce="amax")[:F]


def _scatter_rows(M: int, sel: torch.Tensor, write: torch.Tensor, vals,
                  fill, dtype) -> torch.Tensor:
    """(M,) filled with ``fill`` and ``vals`` written at ``sel`` where
    ``write`` (rows in ``sel`` are unique among writers)."""
    base = torch.full((M,), fill, dtype=dtype, device=sel.device)
    return masked_set(base, sel, vals, write)


def fused_track_step(mp_pos, mp_desc, mp_valid, prev_pose: lie.SE3,
                     pred_pose: lie.SE3, kp_uv, kp_desc, kp_valid,
                     kp_octave, kp_inv_sigma2, cam_params,
                     cam_model: str = cameras.PINHOLE, img_h: int = 480,
                     img_w: int = 752, radius_coarse: float = 15.0,
                     radius_fine: float = 9.0, far_threshold: float = 0.0
                     ) -> TrackStepResult:
    """The reference's compile-check step: coarse and fine dense matches
    (plain PyTorch, as the reference used its dense XLA matcher here) and
    two pose solves."""
    F = kp_uv.shape[0]
    M = mp_pos.shape[0]
    zeros_oct = torch.zeros(M, dtype=torch.int32, device=mp_pos.device)

    def project(pose):
        pc = lie.se3_apply(pose, mp_pos)
        uv = cameras.project(cam_model, cam_params, pc)
        return uv, _visible(pc, uv, mp_valid, img_h, img_w, far_threshold)

    def stage(pose, radius):
        uv, vis = project(pose)
        midx, mok = matcher.search_by_projection(
            uv, mp_desc, vis, zeros_oct, kp_uv, kp_desc, kp_valid,
            kp_octave, radius=radius, max_dist=matcher.TH_HIGH,
            octave_window=16, fused=True)
        mp_of_kp = _invert(midx, mok, F)
        return mp_of_kp, torch.clamp(mp_of_kp, 0, M - 1).long()

    mp_of_kp, sel = stage(pred_pose, radius_coarse)
    pose1, _, _ = pose_opt.pose_optimization(
        prev_pose, mp_pos[sel], kp_uv, kp_inv_sigma2, mp_of_kp >= 0,
        cam_params, cam_model=cam_model, rounds=1, iters_per_round=6)
    mp_of_kp, sel = stage(pose1, radius_fine)
    pose2, kp_inlier, n_in = pose_opt.pose_optimization(
        pose1, mp_pos[sel], kp_uv, kp_inv_sigma2, mp_of_kp >= 0,
        cam_params, cam_model=cam_model, rounds=2, iters_per_round=6)
    write = kp_inlier & (mp_of_kp >= 0)
    feat = torch.arange(F, dtype=torch.int32, device=mp_pos.device)
    return TrackStepResult(
        pose=pose2,
        inliers=_scatter_rows(M, sel, write, True, False, torch.bool),
        n_inliers=n_in,
        matched_feat=_scatter_rows(M, sel, write, feat, -1, torch.int32),
    )


class FrameUpdate(NamedTuple):
    """Everything the host needs back from one tracked frame."""

    pose: lie.SE3
    velocity: lie.SE3
    obs: torch.Tensor          # (F,) feature -> map-point row or -1
    mp_visible: torch.Tensor   # (M,) updated visibility counters
    mp_found: torch.Tensor     # (M,) updated found counters
    counts: torch.Tensor       # (2,) int32: [n_matches, n_inliers]


def fused_frame_update(mp_pos, mp_desc, mp_valid, mp_visible, mp_found,
                       prev_pose: lie.SE3, pred_pose: lie.SE3, kp_uv,
                       kp_desc, kp_valid, kp_octave, inv_sigma2_table,
                       cam_params, mp_normal=None, mp_min_dist=None,
                       mp_max_dist=None, cam_model: str = cameras.PINHOLE,
                       img_h: int = 480, img_w: int = 752,
                       radius_coarse: float = 15.0, radius_fine: float = 9.0,
                       min_matches: int = 20, far_threshold: float = 0.0,
                       num_levels: int = 8) -> FrameUpdate:
    """One tracked frame (TrackWithMotionModel + TrackLocalMap).

    ``mp_visible`` and ``mp_found`` are updated IN PLACE (the reference
    donates those buffers) and returned. With ``mp_normal``/``mp_min_dist``
    /``mp_max_dist`` the full frustum gate set runs (distance band, 60 deg
    view angle, predicted-octave window with a level-scaled radius).
    """
    F = kp_uv.shape[0]
    M = mp_pos.shape[0]
    scale_gates = mp_min_dist is not None
    L = inv_sigma2_table.shape[0]
    inv_s2 = inv_sigma2_table[torch.clamp(kp_octave, 0, L - 1).long()]

    def project(pose):
        pc = lie.se3_apply(pose, mp_pos)
        uv = cameras.project(cam_model, cam_params, pc)
        vis = _visible(pc, uv, mp_valid, img_h, img_w, far_threshold)
        if not scale_gates:
            return uv, vis, None
        d = vec_norm(pc)
        vis = vis & (d >= 0.8 * mp_min_dist) & (d <= 1.2 * mp_max_dist)
        vdir = torch.einsum("ji,mj->mi", pose.R, pc)
        cosv = torch.sum(vdir * mp_normal, dim=-1) / torch.clamp(d, min=1e-9)
        vis = vis & (cosv > 0.5)
        return uv, vis, predict_scale(d, mp_max_dist, num_levels)

    def match_at(uv_pred, vis, radius, pred_oct):
        if scale_gates:
            r_pt = radius * libm.octave_pow(pred_oct)
        else:
            r_pt = torch.full((M,), radius, dtype=torch.float32,
                              device=mp_pos.device)
        # the window rounds as XLA:CPU compiles the reference's dense
        # sum((uv - kp)**2) <= r**2: fma(dv, dv, du*du) (ROADMAP C11)
        idx, best, second = masked_match(
            uv_pred, mp_desc, vis, r_pt, kp_uv, kp_desc, kp_valid,
            mp_octave=pred_oct if scale_gates else None,
            kp_octave=kp_octave if scale_gates else None, fused_window=True)
        ok = ((best <= matcher.TH_HIGH)
              & (best.to(torch.float32)
                 <= matcher.RATIO * second.to(torch.float32)))
        return torch.where(ok, idx, torch.full_like(idx, -1)), ok

    # ---- stage 1: coarse match at the prediction; the widened retry is
    # computed unconditionally and selected on famine (no host sync)
    uv1, vis1, oct1 = project(pred_pose)
    midx0, mok0 = match_at(uv1, vis1, radius_coarse, oct1)
    midxw, mokw = match_at(uv1, vis1, 2.0 * radius_coarse, oct1)
    famine = torch.sum(mok0.to(torch.int32)) < min_matches
    midx = torch.where(famine, midxw, midx0)
    mok = torch.where(famine, mokw, mok0)
    n_match = torch.sum(mok.to(torch.int32))

    mp_of_kp = _invert(midx, mok, F)
    sel = torch.clamp(mp_of_kp, 0, M - 1).long()
    pose1, _, _ = pose_opt.pose_optimization(
        pred_pose, mp_pos[sel], kp_uv, inv_s2, mp_of_kp >= 0,
        cam_params, cam_model=cam_model, rounds=1, iters_per_round=6)

    # ---- stage 2: fine re-match at the refined pose, anchored re-solve
    uv2, vis2, oct2 = project(pose1)
    midx, mok = match_at(uv2, vis2, radius_fine, oct2)
    mp_of_kp = _invert(midx, mok, F)
    sel = torch.clamp(mp_of_kp, 0, M - 1).long()
    pose2, kp_inlier, n_in = pose_opt.pose_optimization(
        prev_pose, mp_pos[sel], kp_uv, inv_s2, mp_of_kp >= 0,
        cam_params, cam_model=cam_model, rounds=2, iters_per_round=6)

    # ---- bookkeeping on the device, in place
    write = kp_inlier & (mp_of_kp >= 0)
    obs = torch.where(write, mp_of_kp, torch.full_like(mp_of_kp, -1))
    mp_visible += vis2.to(mp_visible.dtype)
    mp_found.index_add_(0, sel, write.to(mp_found.dtype))
    velocity = lie.se3_compose(pose2, lie.se3_inverse(prev_pose))
    return FrameUpdate(
        pose=pose2, velocity=velocity, obs=obs, mp_visible=mp_visible,
        mp_found=mp_found,
        counts=torch.stack([n_match, n_in]).to(torch.int32))
