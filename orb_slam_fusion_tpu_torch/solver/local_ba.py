"""Windowed local bundle adjustment with map write-back.

Counterpart of ``orb_slam_fusion_tpu/solver/local_ba.py``: problem build
from the window's observations (with stereo factors where a right-image u
table is given) -> two-phase robust LM -> write-back of the window poses,
the landmark positions and the unbinding of outlier observations.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import cameras, lie
from ..map import map_state as ms
from ..utils import masked_set
from . import ba


def local_ba_step(m: ms.MapState, window: torch.Tensor, fixed: torch.Tensor,
                  inv_sigma2_table: torch.Tensor, cam_params: torch.Tensor,
                  kf_uright: torch.Tensor = None, bf: float = 0.0,
                  cam_model: str = cameras.PINHOLE, iters_first: int = 5,
                  iters_second: int = 10
                  ) -> Tuple[ms.MapState, torch.Tensor, torch.Tensor]:
    """Run local BA over ``window`` (W,) keyframe rows (-1 padded) with
    ``fixed`` (W,) poses held constant; ``kf_uright`` (K, F) gives each
    keyframe feature's right-image u (-1 for a monocular observation) and
    ``bf`` the baseline times fx. Returns (map, costs, n_edges)."""
    W = window.shape[0]
    F = m.n_feat
    L = inv_sigma2_table.shape[0]
    kf_idx, mp_idx, uv, octv, valid = ms.observation_triples(m, window)
    inv_s2 = inv_sigma2_table[torch.clamp(octv, 0, L - 1).long()]
    wclip = torch.clamp(window, 0, m.max_kf - 1).long()
    poses = lie.SE3(m.kf_pose.R[wclip], m.kf_pose.t[wclip])

    prob = ba.make_window_problem(
        poses, m.mp_pos, kf_idx, mp_idx, uv, inv_s2, valid,
        fixed | (window < 0), cam_params, window_size=W,
        fixed_point=~m.mp_valid, **stereo_args(kf_uright, bf, wclip, valid))
    new_poses, new_points, inlier, costs = ba.bundle_adjustment(
        prob, cam_model=cam_model, iters_first=iters_first,
        iters_second=iters_second, window_layout=True)

    # write back; padded window slots are dropped, never clipped onto row 0
    win_ok = window >= 0
    drop = (valid & ~inlier).reshape(W, F)
    kfo_rows = torch.where(drop, torch.full_like(m.kf_obs_mp[wclip], -1),
                           m.kf_obs_mp[wclip])
    new_map = m._replace(
        kf_pose=lie.SE3(masked_set(m.kf_pose.R, window, new_poses.R, win_ok),
                        masked_set(m.kf_pose.t, window, new_poses.t, win_ok)),
        mp_pos=torch.where(m.mp_valid[:, None], new_points, m.mp_pos),
        kf_obs_mp=masked_set(m.kf_obs_mp, window, kfo_rows, win_ok),
    )
    return new_map, costs, torch.sum(valid.to(torch.int32)).to(torch.int32)


def stereo_args(kf_uright, bf: float, wclip: torch.Tensor,
                valid: torch.Tensor) -> dict:
    """The stereo arguments of ``ba.make_window_problem`` for a window:
    each factor's right-image u and its stereo mask (u_R > 0)."""
    if kf_uright is None:
        return {}
    ur = kf_uright[wclip].reshape(-1)
    return dict(u_right=ur, stereo_mask=valid & (ur > 0), bf=bf)
