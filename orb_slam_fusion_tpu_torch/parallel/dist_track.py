"""Distributed per-frame tracking: the map table sharded over the mesh.

Counterpart of ``orb_slam_fusion_tpu/parallel/dist_track.py``:

* **Map points shard** over the mesh: each shard owns M/D rows of the
  position, descriptor and counter tables and matches them against the
  frame's (replicated) keypoints entirely locally: a map point's best
  keypoint depends only on its own row. Each match stage calls
  ``frontend.masked_match.masked_match`` once per shard, so on a CUDA
  device a tracked frame launches the masked-match kernel 2 x D times
  (coarse, then fine, on every shard).
* **The pose replicates**: each Gauss-Newton iteration reduces the owned
  matches to a partial 6x6 (H, g), the partials are added in rank order,
  and the solve and pose update run once on the mesh's first device.

The window test is the reference's ``sum((uv - kp)**2) <= r*r`` as XLA:CPU
rounds it (a fused multiply-add of the second square onto the first):
``masked_match(..., fused_window=True)``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import cameras, lie
from ..frontend import matcher
from ..frontend.masked_match import masked_match
from ..solver.ba import solve_pos
from ..solver.robust import CHI2_2D, huber_weight
from .mesh import SlamMesh

# kernel launches of one distributed frame per shard: the coarse and the
# fine match stage
MATCH_LAUNCHES_PER_SHARD = 2


class DistFrameResult(NamedTuple):
    pose: lie.SE3              # optimized Tcw (replicated)
    match_idx: torch.Tensor    # (M,) keypoint row per map point or -1
    inlier: torch.Tensor       # (M,) bool
    mp_visible: torch.Tensor   # (M,) updated counters
    mp_found: torch.Tensor     # (M,) updated counters
    counts: torch.Tensor       # (2,) [n_matches, n_inliers]


def distributed_frame_update(
    mp_pos: torch.Tensor,        # (M, 3), M divisible by the mesh size
    mp_desc: torch.Tensor,       # (M, 8) int32
    mp_valid: torch.Tensor,      # (M,)
    mp_visible: torch.Tensor,    # (M,) int32
    mp_found: torch.Tensor,      # (M,) int32
    prev_pose: lie.SE3,
    pred_pose: lie.SE3,
    kp_uv: torch.Tensor,         # (F, 2) replicated
    kp_desc: torch.Tensor,       # (F, 8) int32
    kp_valid: torch.Tensor,      # (F,)
    kp_inv_sigma2: torch.Tensor,  # (F,)
    cam_params: torch.Tensor,
    mesh: SlamMesh,
    cam_model: str = cameras.PINHOLE,
    img_h: int = 480,
    img_w: int = 752,
    radius_coarse: float = 15.0,
    radius_fine: float = 9.0,
    iters: int = 6,
) -> DistFrameResult:
    """One tracked frame against a mesh-sharded map point table. Outputs
    on the mesh's first device."""
    D = mesh.size
    if mp_pos.shape[0] % D:
        raise ValueError(f"{mp_pos.shape[0]} map rows do not divide over "
                         f"{D} shards (pad_map_for_mesh)")
    home = mesh.home
    dtype = mp_pos.dtype
    F = kp_uv.shape[0]
    pos = mesh.shard(mp_pos)
    desc = mesh.shard(mp_desc.to(torch.int32))
    valid = mesh.shard(mp_valid)
    kp = [mesh.replicate(x) for x in (kp_uv, kp_desc.to(torch.int32),
                                       kp_valid, kp_inv_sigma2, cam_params)]
    kuv, kdesc, kval, kis2, cams = kp

    def project(pose_reps):
        out = []
        for d in range(D):
            pc = lie.se3_apply(pose_reps[d], pos[d])
            uv = cameras.project(cam_model, cams[d], pc)
            vis = (valid[d] & (pc[..., 2] > 0.05)
                   & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
                   & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
            out.append((uv.contiguous(), vis))
        return out

    def match_at(proj, radius):
        res = []
        for d in range(D):
            uv, vis = proj[d]
            idx, best, second = masked_match(
                uv, desc[d], vis, radius, kuv[d], kdesc[d], kval[d],
                fused_window=True)
            ok = ((best <= matcher.TH_HIGH)
                  & (best.to(torch.float32)
                     <= matcher.RATIO * second.to(torch.float32)))
            res.append((torch.where(ok, idx, torch.full_like(idx, -1)), ok))
        return res

    def residual(pose, d, midx_c):
        pc = lie.se3_apply(pose, pos[d])
        pred = cameras.project(cam_model, cams[d], pc)
        return pc, pred - kuv[d][midx_c]

    def gn_solve(pose0, matches, n_iters):
        """Replicated pose from the psum-reduced normal equations."""
        obs = []
        for d in range(D):
            midx, mok = matches[d]
            midx_c = torch.clamp(midx, 0, F - 1).long()
            obs.append((midx_c, kis2[d][midx_c], mok))
        eye6 = torch.eye(6, dtype=dtype, device=home)
        pose = lie.SE3(pose0.R.to(home), pose0.t.to(home))
        for _ in range(n_iters):
            reps = mesh.replicate(pose)
            parts = []
            for d in range(D):
                midx_c, w_info, mok = obs[d]
                pc, r = residual(reps[d], d, midx_c)
                Jproj = cameras.project_jac(cam_model, cams[d], pc)
                eye = torch.eye(3, dtype=dtype, device=pc.device).expand(
                    pc.shape[:-1] + (3, 3))
                J = Jproj @ torch.cat([eye, -lie.hat(pc)], dim=-1)
                chi2 = torch.sum(r * r, dim=-1) * w_info
                w = torch.where(mok & (pc[..., 2] > 1e-4),
                                huber_weight(chi2, CHI2_2D) * w_info,
                                torch.zeros_like(chi2))
                parts.append((torch.einsum("nik,n,nil->kl", J, w, J),
                              torch.einsum("nik,n,ni->k", J, w, r)))
            H, g = mesh.psum(parts)
            damped = H + 1e-5 * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = -solve_pos(damped, g)
            new = lie.se3_boxplus(pose, dx)
            ok = torch.isfinite(new.t).all() & torch.isfinite(new.R).all()
            pose = lie.SE3(torch.where(ok, new.R, pose.R),
                           torch.where(ok, new.t, pose.t))
        return pose

    def classify(pose, matches, active):
        reps = mesh.replicate(pose)
        out = []
        for d in range(D):
            midx_c = torch.clamp(matches[d][0], 0, F - 1).long()
            pc, r = residual(reps[d], d, midx_c)
            chi2 = torch.sum(r * r, dim=-1) * kis2[d][midx_c]
            out.append(active[d] & (chi2 <= CHI2_2D) & (pc[..., 2] > 1e-4))
        return out

    def count(flags):
        return mesh.psum([torch.sum(f.to(torch.int32)) for f in flags])

    # stage 1: coarse match at the prediction, solve from there
    proj = project(mesh.replicate(pred_pose))
    matches = match_at(proj, radius_coarse)
    pose1 = gn_solve(pred_pose, matches, iters)

    # stage 2: fine re-match at the refined pose, anchored re-solve
    proj = project(mesh.replicate(pose1))
    matches = match_at(proj, radius_fine)
    mok = [m[1] for m in matches]
    n_match = count(mok)
    pose2 = gn_solve(prev_pose, matches, iters)

    # chi2 outlier toggle and a final round (the reference's
    # between-round re-classification, collapsed to one toggle)
    inlier = classify(pose2, matches, mok)
    pose2 = gn_solve(pose2, [(m[0], i) for m, i in zip(matches, inlier)],
                     iters // 2 + 1)
    inlier = classify(pose2, matches, mok)
    n_in = count(inlier)

    vis = mesh.gather([p[1] for p in proj])
    inl = mesh.gather(inlier)
    return DistFrameResult(
        pose=pose2, match_idx=mesh.gather([m[0] for m in matches]),
        inlier=inl, mp_visible=mp_visible.to(home) + vis.to(torch.int32),
        mp_found=mp_found.to(home) + inl.to(torch.int32),
        counts=torch.stack([n_match, n_in]).to(torch.int32))


def pad_map_for_mesh(mesh: SlamMesh, mp_pos, mp_desc, mp_valid, mp_visible,
                     mp_found) -> Tuple[torch.Tensor, ...]:
    """Pad the map tables so the row count divides the mesh size. Padded
    rows are invalid, so they are inert in matching and solving."""
    return (mesh.pad(mp_pos), mesh.pad(mp_desc), mesh.pad(mp_valid, False),
            mesh.pad(mp_visible), mesh.pad(mp_found))
