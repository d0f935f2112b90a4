"""Multi-map atlas: archived maps and map merging.

Counterpart of ``orb_slam_fusion_tpu/map/atlas.py`` (the reference's Atlas
and the table side of MergeLocal): ``transform_map`` moves a map's
geometry by a world-frame Sim3 (camera centres, rotations, points, their
normals and scale bands), and ``merge_maps`` welds the newer map into the
older one's frame by appending its rows with index offsets.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import lie
from . import map_state as ms


def transform_map(m: ms.MapState, S: lie.Sim3) -> ms.MapState:
    """Apply a world-frame Sim3 x' = S(x) to every pose and point: camera
    centres move as C' = S(C), R'_cw = R_cw R_S^T, t'_cw = -R'_cw C';
    normals (world directions) rotate; the metric scale band scales."""
    C = -torch.einsum("kji,kj->ki", m.kf_pose.R, m.kf_pose.t)
    C2 = lie.sim3_apply(S, C)
    R2 = m.kf_pose.R @ S.R.T
    t2 = -torch.einsum("kij,kj->ki", R2, C2)
    pts2 = lie.sim3_apply(S, m.mp_pos)
    nrm2 = torch.einsum("ij,kj->ki", S.R, m.mp_normal)
    v = m.mp_valid[:, None]
    return m._replace(
        kf_pose=lie.SE3(R2, t2),
        mp_pos=torch.where(v, pts2, m.mp_pos),
        mp_normal=torch.where(v, nrm2, m.mp_normal),
        mp_min_dist=m.mp_min_dist * S.s,
        mp_max_dist=torch.where(m.mp_max_dist < 1e8, m.mp_max_dist * S.s,
                                m.mp_max_dist),
    )


def _put(table: torch.Tensor, start: int, rows: torch.Tensor
         ) -> torch.Tensor:
    out = table.clone()
    out[start:start + rows.shape[0]] = rows
    return out


def merge_maps(m_old: ms.MapState, m_new: ms.MapState,
               S_new_to_old: lie.Sim3
               ) -> Tuple[Optional[ms.MapState], int, int]:
    """Weld m_new into m_old's frame (S_new_to_old maps new-map world
    coordinates into the old map's) and append its rows. Returns (merged
    map, kf_offset, mp_offset), or (None, 0, 0) if the old map lacks the
    capacity."""
    n_kf_old, n_mp_old = int(m_old.n_kf), int(m_old.n_mp)
    n_kf_new, n_mp_new = int(m_new.n_kf), int(m_new.n_mp)
    if (n_kf_old + n_kf_new > m_old.max_kf
            or n_mp_old + n_mp_new > m_old.max_mp):
        return None, 0, 0
    t = transform_map(m_new, S_new_to_old)
    ko, mo = n_kf_old, n_mp_old
    nk, nm = n_kf_new, n_mp_new
    obs = t.kf_obs_mp[:nk]
    obs = torch.where(obs >= 0, obs + mo, obs)
    dev = m_old.n_kf.device
    merged = m_old._replace(
        kf_pose=lie.SE3(_put(m_old.kf_pose.R, ko, t.kf_pose.R[:nk]),
                        _put(m_old.kf_pose.t, ko, t.kf_pose.t[:nk])),
        kf_valid=_put(m_old.kf_valid, ko, t.kf_valid[:nk]),
        kf_timestamp=_put(m_old.kf_timestamp, ko, t.kf_timestamp[:nk]),
        kf_uv=_put(m_old.kf_uv, ko, t.kf_uv[:nk]),
        kf_desc=_put(m_old.kf_desc, ko, t.kf_desc[:nk]),
        kf_octave=_put(m_old.kf_octave, ko, t.kf_octave[:nk]),
        kf_feat_valid=_put(m_old.kf_feat_valid, ko, t.kf_feat_valid[:nk]),
        kf_obs_mp=_put(m_old.kf_obs_mp, ko, obs),
        mp_pos=_put(m_old.mp_pos, mo, t.mp_pos[:nm]),
        mp_desc=_put(m_old.mp_desc, mo, t.mp_desc[:nm]),
        mp_valid=_put(m_old.mp_valid, mo, t.mp_valid[:nm]),
        mp_normal=_put(m_old.mp_normal, mo, t.mp_normal[:nm]),
        mp_ref_kf=_put(m_old.mp_ref_kf, mo, t.mp_ref_kf[:nm] + ko),
        mp_visible=_put(m_old.mp_visible, mo, t.mp_visible[:nm]),
        mp_found=_put(m_old.mp_found, mo, t.mp_found[:nm]),
        mp_first_kf=_put(m_old.mp_first_kf, mo, t.mp_first_kf[:nm] + ko),
        mp_min_dist=_put(m_old.mp_min_dist, mo, t.mp_min_dist[:nm]),
        mp_max_dist=_put(m_old.mp_max_dist, mo, t.mp_max_dist[:nm]),
        n_kf=torch.tensor(ko + nk, dtype=torch.int32, device=dev),
        n_mp=torch.tensor(mo + nm, dtype=torch.int32, device=dev),
    )
    return merged, ko, mo


class ArchivedMap(NamedTuple):
    map: ms.MapState
    bow: torch.Tensor        # (max_kf, V) keyframe BoW matrix
    present: torch.Tensor    # (max_kf,)
    # the archived session's per-keyframe inertial side tables (kf_vel,
    # kf_bias, kf_pre, kf_time, kf_raw lists), None for a visual map
    inertial: Optional[dict] = None


class Atlas:
    """Container of the non-active maps (reference Atlas)."""

    def __init__(self):
        self.archived: List[ArchivedMap] = []

    def archive(self, m: ms.MapState, bow, present, min_kfs: int = 5,
                inertial: Optional[dict] = None) -> bool:
        if int(m.n_kf) < min_kfs:
            return False
        self.archived.append(ArchivedMap(m, bow, present, inertial))
        return True

    def __len__(self):
        return len(self.archived)
