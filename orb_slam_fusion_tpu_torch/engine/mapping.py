"""Fused keyframe-insertion mapping step.

Counterpart of ``orb_slam_fusion_tpu/engine/mapping.py``: keyframe insert,
mutual-match triangulation against the previous keyframes, duplicate
fusion, map-point culling, distinctive-descriptor refresh and the normal /
scale-band refresh, all on the device with static shapes. The dense
matches here (F x F mutual, M x F fusion) are plain PyTorch, as they were
XLA work in the reference. Scatters keep their indices unique. Where
several writers may target one row (fusion's replacement table, and the
descriptor and scale-band refresh of a point two features share after
fusion), the last writer wins, as in the reference's CPU scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import cameras, lie
from ..frontend import matcher
from ..map import map_state as ms
from ..map.map_state import vec_norm
from ..utils import masked_set, masked_set_last
from ..utils import libm
from ..utils.fused import sum_sq_f32


def _triangulate_pair(pose_a: lie.SE3, pose_b: lie.SE3, rays_a, rays_b,
                      pair_valid, min_parallax_cos: float = 0.9998,
                      far_threshold: float = 0.0, sigma2_a=None,
                      sigma2_b=None, inv_f=1 / 460.0):
    """Epipolar gate, midpoint + GN triangulation and the parallax,
    depth and per-view reprojection gates. Returns (points_w, good)."""
    one = torch.ones_like(rays_a[..., 0])
    s2a = one if sigma2_a is None else sigma2_a
    s2b = one if sigma2_b is None else sigma2_b
    T_ba = lie.se3_compose(pose_b, lie.se3_inverse(pose_a))

    E = lie.hat(T_ba.t) @ T_ba.R
    line = torch.einsum("ij,nj->ni", E, rays_a)
    ep = torch.sum(rays_b * line, dim=-1)
    sampson = ep * ep / torch.clamp(line[..., 0] ** 2 + line[..., 1] ** 2,
                                    min=1e-12)
    pair_valid = pair_valid & (sampson < 3.84 * s2b * inv_f * inv_f)

    X_a = cameras.triangulate(rays_a, rays_b, T_ba.R, T_ba.t, exact=False)
    X_b = lie.se3_apply(T_ba, X_a)
    z_a, z_b = X_a[..., 2], X_b[..., 2]

    C_b_in_a = lie.se3_apply(lie.se3_inverse(T_ba), torch.zeros_like(X_a))
    v1 = X_a
    v2 = X_a - C_b_in_a
    cosp = torch.sum(v1 * v2, dim=-1) / torch.clamp(
        vec_norm(v1) * vec_norm(v2), min=1e-12)

    e_a = sum_sq_f32(X_a[..., :2] / torch.clamp(z_a[..., None], min=1e-9)
                     - rays_a[..., :2])
    e_b = sum_sq_f32(X_b[..., :2] / torch.clamp(z_b[..., None], min=1e-9)
                     - rays_b[..., :2])
    th_a = 5.991 * s2a * inv_f * inv_f
    th_b = 5.991 * s2b * inv_f * inv_f
    good = (pair_valid & (z_a > 0.05) & (z_b > 0.05)
            & (cosp < min_parallax_cos) & (e_a < th_a) & (e_b < th_b))
    if far_threshold > 0:
        good = good & (z_a < far_threshold) & (z_b < far_threshold)
    return lie.se3_apply(lie.se3_inverse(pose_a), X_a), good


def top_covisible(m: ms.MapState, obs: torch.Tensor, exclude_lo,
                  k: int = 3) -> torch.Tensor:
    """Top-k keyframes sharing most map points with the frame's ``obs``,
    rows below ``exclude_lo`` only; (k,) int32, -1 padded. Ties go to the
    lowest row, as ``lax.top_k`` orders them."""
    M = m.max_mp
    mask = torch.zeros(M, dtype=torch.bool, device=obs.device)
    mask = masked_set(mask, obs, True, obs >= 0)
    rows = torch.clamp(m.kf_obs_mp, 0, M - 1).long()
    shares = torch.sum(mask[rows] & (m.kf_obs_mp >= 0) & m.kf_feat_valid,
                       dim=1, dtype=torch.int32)
    kfa = torch.arange(m.max_kf, device=obs.device)
    ok = m.kf_valid & (kfa < exclude_lo)
    shares = torch.where(ok, shares, torch.full_like(shares, -1))
    best, ids = torch.sort(shares, descending=True, stable=True)
    best, ids = best[:k], ids[:k].to(torch.int32)
    return torch.where(best > 0, ids, torch.full_like(ids, -1))


class MappingResult(NamedTuple):
    map: ms.MapState
    stats: torch.Tensor   # (2,) int32: [new keyframe row or -1, n tracked]


def mapping_step(m: ms.MapState, pose: lie.SE3, timestamp, kp_uv, kp_desc,
                 kp_octave, kp_valid, obs, prev_ids, cam_params,
                 cam_model: str = cameras.PINHOLE, img_h: int = 480,
                 img_w: int = 752, n_prev: int = 3,
                 culling_found_ratio: float = 0.25,
                 far_threshold: float = 0.0, num_levels: int = 8
                 ) -> MappingResult:
    """Insert a keyframe and do all per-keyframe mapping work."""
    F = kp_uv.shape[0]
    dev = kp_uv.device
    i32 = torch.int32

    # ---- 1. keyframe insert --------------------------------------------
    m, kf_id = ms.add_keyframe(m, pose, timestamp, kp_uv, kp_desc,
                               kp_octave, kp_valid, obs)
    kf_ok = kf_id >= 0
    kf_c = torch.clamp(kf_id, 0, m.max_kf - 1)

    # ---- 2. triangulate unmatched features against recent keyframes ---
    rays_cur = cameras.unproject(cam_model, cam_params, kp_uv)
    cam_center = lie.se3_apply(lie.se3_inverse(pose),
                               torch.zeros(3, dtype=kp_uv.dtype, device=dev))
    cur_obs = obs
    feat_rows = torch.arange(F, dtype=i32, device=dev)
    for p in range(n_prev):
        prev = prev_ids[p]
        prev_ok = (prev >= 0) & kf_ok
        prev_c = torch.clamp(prev, 0, m.max_kf - 1)
        pl = prev_c.long()

        prev_uv = m.kf_uv[pl]
        prev_desc = m.kf_desc[pl]
        prev_un = m.kf_feat_valid[pl] & (m.kf_obs_mp[pl] < 0) & prev_ok
        cur_un = kp_valid & (cur_obs < 0)
        pidx, pok = matcher.match_mutual(prev_desc, prev_un, kp_desc,
                                         cur_un, max_dist=matcher.TH_LOW)
        pidx_c = torch.clamp(pidx, 0, F - 1).long()

        rays_prev = cameras.unproject(cam_model, cam_params, prev_uv)
        prev_pose = lie.SE3(m.kf_pose.R[pl], m.kf_pose.t[pl])
        s2_prev = libm.octave_pow(2.0 * torch.clamp(
            m.kf_octave[pl], 0, num_levels - 1).to(torch.float32))
        s2_cur = libm.octave_pow(2.0 * torch.clamp(
            kp_octave[pidx_c], 0, num_levels - 1).to(torch.float32))
        X_w, good = _triangulate_pair(
            prev_pose, pose, rays_prev, rays_cur[pidx_c], pok,
            far_threshold=far_threshold, sigma2_a=s2_prev, sigma2_b=s2_cur,
            inv_f=1.0 / cam_params[0])
        good = good & prev_ok

        normals = X_w - cam_center
        dist_new = vec_norm(normals)
        normals = normals / torch.clamp(dist_new[:, None], min=1e-9)
        min_d, max_d = ms.scale_invariance_band(
            dist_new, kp_octave[pidx_c], num_levels)
        m, new_ids = ms.add_map_points(
            m, X_w, kp_desc[pidx_c], normals, kf_c, kf_c, good,
            min_dist=min_d, max_dist=max_d)

        # register the observations in both keyframes
        write = new_ids >= 0
        kfo = m.kf_obs_mp
        row_prev = masked_set(kfo[pl], feat_rows, new_ids, write)
        kfo = ms.put_row(kfo, prev_c, prev_ok, row_prev)
        row_cur = masked_set(kfo[kf_c.long()], pidx_c, new_ids,
                             write & (pidx >= 0))
        kfo = ms.put_row(kfo, kf_c, kf_ok, row_cur)
        m = m._replace(kf_obs_mp=kfo)
        cur_obs = m.kf_obs_mp[kf_c.long()]

    # ---- 3. duplicate fusion: where a projected point matches a feature
    # bound to a DIFFERENT point, the older (smaller-row) point absorbs ---
    pc = lie.se3_apply(pose, m.mp_pos)
    uv_pred = cameras.project(cam_model, cam_params, pc)
    vis = (m.mp_valid & (pc[..., 2] > 0.05)
           & (uv_pred[..., 0] >= 0) & (uv_pred[..., 0] < img_w)
           & (uv_pred[..., 1] >= 0) & (uv_pred[..., 1] < img_h))
    dist_all = vec_norm(pc)
    vis = vis & (dist_all >= 0.8 * m.mp_min_dist) \
        & (dist_all <= 1.2 * m.mp_max_dist)
    pred_oct = ms.predict_scale(dist_all, m.mp_max_dist, num_levels)
    midx, mok = matcher.search_by_projection(
        uv_pred, m.mp_desc, vis, pred_oct, kp_uv, kp_desc, kp_valid,
        kp_octave, radius=4.0 * libm.octave_pow(pred_oct),
        max_dist=matcher.TH_LOW, octave_window=1, fused=True)
    midx_c = torch.clamp(midx, 0, F - 1).long()
    bound = cur_obs[midx_c]
    mp_rows = torch.arange(m.max_mp, dtype=i32, device=dev)
    dup = mok & kf_ok & (bound >= 0) & (bound != mp_rows)
    keep = torch.where(bound < mp_rows, bound, mp_rows)
    kill = torch.where(bound < mp_rows, mp_rows, bound)
    replace = masked_set_last(mp_rows.clone(), kill, keep, dup)
    kfo = m.kf_obs_mp
    kfo = torch.where(kfo >= 0, replace[torch.clamp(kfo, min=0).long()], kfo)
    killed = masked_set_last(
        torch.zeros(m.max_mp, dtype=torch.bool, device=dev), kill, True, dup)
    m = m._replace(kf_obs_mp=kfo, mp_valid=m.mp_valid & ~killed)

    # ---- 4. map-point culling: low found/visible ratio -----------------
    ratio = m.mp_found / torch.clamp(m.mp_visible, min=1)
    bad = (m.mp_visible >= 8) & (ratio < culling_found_ratio)
    m = m._replace(mp_valid=m.mp_valid & ~bad)

    # ---- 4.5 distinctive-descriptor refresh over the temporal window ---
    cur_obs = m.kf_obs_mp[kf_c.long()]
    n_temp = min(3, n_prev)
    win = torch.cat([prev_ids[:n_temp].to(i32), kf_c.view(1).to(i32)])
    Wn = n_temp + 1
    win_c = torch.clamp(win, 0, m.max_kf - 1).long()
    win_valid = (win >= 0) & m.kf_valid[win_c]
    obs_win = m.kf_obs_mp[win_c]                                # (W, F)
    Mp1 = m.max_mp + 1
    tgt = torch.where(obs_win >= 0, obs_win,
                      torch.full_like(obs_win, m.max_mp)).long()
    w_off = (torch.arange(Wn, device=dev) * Mp1)[:, None]
    inv = torch.full((Wn * Mp1,), -1, dtype=i32, device=dev)
    inv = inv.scatter_reduce(0, (w_off + tgt).reshape(-1),
                             feat_rows.expand(Wn, F).reshape(-1),
                             reduce="amax").view(Wn, Mp1)
    rows_cur_pt = torch.clamp(cur_obs, 0, m.max_mp - 1).long()
    fidx_w = inv[:, :-1][:, rows_cur_pt]                        # (W, F)
    has_obs = (fidx_w >= 0) & win_valid[:, None] & (cur_obs >= 0)[None, :]
    desc_w = m.kf_desc[win_c[:, None],
                       torch.clamp(fidx_w, 0, F - 1).long()]    # (W, F, 8)
    pd = torch.zeros((Wn, Wn, F), dtype=i32, device=dev)
    for w in range(8):
        pd += matcher.popcount32(desc_w[:, None, :, w]
                                 ^ desc_w[None, :, :, w])
    pd = pd.permute(2, 0, 1)                                    # (F, W, W)
    hT = has_obs.T
    pair_ok = hT[:, :, None] & hT[:, None, :]
    BIGD = 1 << 12
    pd = torch.where(pair_ok, pd, torch.full_like(pd, BIGD))
    srt = torch.sort(pd, dim=-1).values
    cnt = torch.sum(hT, dim=-1, dtype=i32)                      # (F,)
    med_pos = torch.clamp((cnt - 1) // 2, 0, Wn - 1).long()
    med = torch.gather(srt, 2, med_pos[:, None, None].expand(F, Wn, 1))[
        ..., 0]
    med = torch.where(hT, med, torch.full_like(med, BIGD))
    # argmin, lowest window slot on ties
    med_min = torch.amin(med, dim=-1, keepdim=True)
    slots = torch.arange(Wn, device=dev)
    best_w = torch.amin(torch.where(med == med_min, slots,
                                    torch.full_like(slots, Wn)), dim=-1)
    rep = desc_w[best_w, torch.arange(F, device=dev)]           # (F, 8)
    d_rep = matcher.hamming_distance_rows(m.mp_desc[rows_cur_pt], kp_desc)
    do_write = (cur_obs >= 0) & (cnt >= 2) & kf_ok & (d_rep > 24)
    m = m._replace(mp_desc=masked_set_last(m.mp_desc, rows_cur_pt, rep,
                                           do_write))

    # ---- 5. normal + scale-band refresh over all observing keyframes ---
    memb = ms.observation_mask(m).to(torch.float32)             # (K, M)
    C_all = -torch.einsum("kji,kj->ki", m.kf_pose.R, m.kf_pose.t)
    x2 = sum_sq_f32(m.mp_pos)[None, :]
    c2 = sum_sq_f32(C_all)[:, None]
    xc = C_all @ m.mp_pos.T
    d_km = torch.sqrt(torch.clamp(x2 + c2 - 2.0 * xc, min=1e-12))
    w_km = memb / d_km
    cnt_m = torch.sum(memb, dim=0)
    sum_w = torch.sum(w_km, dim=0)
    dir_sum = m.mp_pos * sum_w[:, None] - w_km.T @ C_all
    nn = vec_norm(dir_sum)[:, None]
    new_normal = torch.where((cnt_m > 0)[:, None],
                             dir_sum / torch.clamp(nn, min=1e-9),
                             m.mp_normal)
    obs_cur = m.kf_obs_mp[kf_c.long()]
    rows = torch.clamp(obs_cur, 0, m.max_mp - 1).long()
    d_f = vec_norm(m.mp_pos[rows] - cam_center[None, :])
    min_f, max_f = ms.scale_invariance_band(d_f, kp_octave, num_levels)
    write_band = (obs_cur >= 0) & kp_valid & kf_ok
    m = m._replace(
        mp_normal=new_normal,
        mp_min_dist=masked_set_last(m.mp_min_dist, rows, min_f, write_band),
        mp_max_dist=masked_set_last(m.mp_max_dist, rows, max_f, write_band),
    )
    n_tracked = torch.sum((m.kf_obs_mp[kf_c.long()] >= 0).to(i32))
    return MappingResult(map=m, stats=torch.stack([kf_id.to(i32),
                                                   n_tracked.to(i32)]))
