"""Fixed-capacity SoA map state and its update ops.

Counterpart of ``orb_slam_fusion_tpu/map/map_state.py``: the same tables,
capacities and validity masks, as tensors on one device. Descriptors are
``(…, 8)`` int32 holding the reference's uint32 bit patterns (torch has no
popcount and no logical shift on uint32). Updates are functional, as in
the reference: they return a new ``MapState`` and leave the input alone.
The reference's ``.at[].set(mode="drop")`` becomes ``utils.masked_set``,
whose scatter indices stay unique. Compaction front-packs the valid rows
with a stable sort and growth pads the tables, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import lie, resolve_device
from ..utils import libm
from ..utils import masked_set


class MapState(NamedTuple):
    """All map data as padded tensors (K keyframes, F features, M points)."""

    # --- keyframes -------------------------------------------------------
    kf_pose: lie.SE3              # (K,) Tcw
    kf_valid: torch.Tensor        # (K,) bool
    kf_timestamp: torch.Tensor    # (K,) float32
    kf_uv: torch.Tensor           # (K, F, 2)
    kf_desc: torch.Tensor         # (K, F, 8) int32 bit patterns
    kf_octave: torch.Tensor       # (K, F) int32
    kf_feat_valid: torch.Tensor   # (K, F) bool
    kf_obs_mp: torch.Tensor       # (K, F) int32 map-point row or -1

    # --- map points ------------------------------------------------------
    mp_pos: torch.Tensor          # (M, 3)
    mp_desc: torch.Tensor         # (M, 8) int32 bit patterns
    mp_valid: torch.Tensor        # (M,) bool
    mp_normal: torch.Tensor       # (M, 3)
    mp_ref_kf: torch.Tensor       # (M,) int32
    mp_visible: torch.Tensor      # (M,) int32
    mp_found: torch.Tensor        # (M,) int32
    mp_first_kf: torch.Tensor     # (M,) int32
    mp_min_dist: torch.Tensor     # (M,)
    mp_max_dist: torch.Tensor     # (M,)

    # --- counters (0-d int32 tensors on the map's device) ---------------
    n_kf: torch.Tensor
    n_mp: torch.Tensor

    @property
    def max_kf(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def max_mp(self) -> int:
        return self.mp_valid.shape[0]

    @property
    def n_feat(self) -> int:
        return self.kf_uv.shape[1]


def make_empty_map(max_kf: int, max_mp: int, n_feat: int,
                   dtype=torch.float32, device=None) -> MapState:
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    f = dict(dtype=dtype, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return MapState(
        kf_pose=lie.se3_identity((max_kf,), dtype, dev),
        kf_valid=torch.zeros(max_kf, **b),
        kf_timestamp=torch.zeros(max_kf, **f),
        kf_uv=torch.zeros((max_kf, n_feat, 2), **f),
        kf_desc=torch.zeros((max_kf, n_feat, 8), **i32),
        kf_octave=torch.zeros((max_kf, n_feat), **i32),
        kf_feat_valid=torch.zeros((max_kf, n_feat), **b),
        kf_obs_mp=torch.full((max_kf, n_feat), -1, **i32),
        mp_pos=torch.zeros((max_mp, 3), **f),
        mp_desc=torch.zeros((max_mp, 8), **i32),
        mp_valid=torch.zeros(max_mp, **b),
        mp_normal=torch.zeros((max_mp, 3), **f),
        mp_ref_kf=torch.zeros(max_mp, **i32),
        mp_visible=torch.zeros(max_mp, **i32),
        mp_found=torch.zeros(max_mp, **i32),
        mp_first_kf=torch.zeros(max_mp, **i32),
        mp_min_dist=torch.zeros(max_mp, **f),
        mp_max_dist=torch.full((max_mp,), 1e9, **f),
        n_kf=torch.zeros((), **i32),
        n_mp=torch.zeros((), **i32),
    )


SCALE_FACTOR = 1.2  # reference ORB pyramid scale


def vec_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x*x)) over the last axis, as ``jnp.linalg.norm`` computes
    it (``torch.linalg.norm`` may round differently, and the predicted
    octave takes the ceiling of a log of a ratio of such norms)."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def scale_invariance_band(dist, octave, num_levels: int,
                          scale: float = SCALE_FACTOR):
    """(min_dist, max_dist) of a point created at `dist` on `octave`."""
    max_d = dist * libm.octave_pow(octave, scale).to(dist.dtype)
    min_d = max_d * (scale ** -(num_levels - 1))
    return min_d, max_d


def predict_scale(dist, max_dist, num_levels: int,
                  scale: float = SCALE_FACTOR) -> torch.Tensor:
    """Predicted pyramid octave ceil(log(max/d)/log(s)), clipped; points
    with the 1e9 sentinel band predict octave 0."""
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(libm.log(ratio) / float(np.float32(np.log(scale))))
    lvl = torch.where(max_dist < 1e8, lvl, torch.zeros_like(lvl))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int32)


def put_row(table: torch.Tensor, k: torch.Tensor, ok: torch.Tensor, val
            ) -> torch.Tensor:
    """Copy of ``table`` with row ``k`` set to ``val`` where ``ok``."""
    val = torch.as_tensor(val, dtype=table.dtype, device=table.device)
    row = torch.where(ok, val.expand(table.shape[1:]), table[k])
    return table.index_copy(0, k.view(1).long(), row.unsqueeze(0))


def add_keyframe(m: MapState, pose: lie.SE3, timestamp, uv, desc, octave,
                 feat_valid, obs_mp) -> Tuple[MapState, torch.Tensor]:
    """Append a keyframe at slot n_kf. Returns (map, kf_id or -1 if full)."""
    k = m.n_kf
    ok = k < m.max_kf
    ks = torch.clamp(k, 0, m.max_kf - 1)

    def put(table, val):
        return put_row(table, ks, ok, val)

    m = m._replace(
        kf_pose=lie.SE3(put(m.kf_pose.R, pose.R), put(m.kf_pose.t, pose.t)),
        kf_valid=put(m.kf_valid, True),
        kf_timestamp=put(m.kf_timestamp, timestamp),
        kf_uv=put(m.kf_uv, uv),
        kf_desc=put(m.kf_desc, desc),
        kf_octave=put(m.kf_octave, octave),
        kf_feat_valid=put(m.kf_feat_valid, feat_valid),
        kf_obs_mp=put(m.kf_obs_mp, obs_mp),
        n_kf=m.n_kf + ok.to(torch.int32),
    )
    return m, torch.where(ok, k, torch.full_like(k, -1))


def add_map_points(m: MapState, pos, desc, normal, ref_kf, first_kf,
                   valid_new, min_dist=None, max_dist=None
                   ) -> Tuple[MapState, torch.Tensor]:
    """Append the ``valid_new`` rows of a batch into the next free slots
    (prefix-sum compaction, one scatter per table, no host sync).
    Returns (map, assigned ids (B,) or -1)."""
    B = pos.shape[0]
    dev = pos.device
    if min_dist is None:
        min_dist = torch.zeros(B, dtype=pos.dtype, device=dev)
    if max_dist is None:
        max_dist = torch.full((B,), 1e9, dtype=pos.dtype, device=dev)
    offs = torch.cumsum(valid_new.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = m.n_mp + offs
    ok = valid_new & (slots < m.max_mp)
    zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)

    m = m._replace(
        mp_pos=masked_set(m.mp_pos, slots, pos, ok),
        mp_desc=masked_set(m.mp_desc, slots, desc, ok),
        mp_valid=masked_set(m.mp_valid, slots, True, ok),
        mp_normal=masked_set(m.mp_normal, slots, normal, ok),
        mp_ref_kf=masked_set(m.mp_ref_kf, slots, ref_kf, ok),
        mp_first_kf=masked_set(m.mp_first_kf, slots, first_kf, ok),
        mp_visible=masked_set(m.mp_visible, slots, zeros_i, ok),
        mp_found=masked_set(m.mp_found, slots, zeros_i, ok),
        mp_min_dist=masked_set(m.mp_min_dist, slots, min_dist, ok),
        mp_max_dist=masked_set(m.mp_max_dist, slots, max_dist, ok),
        n_mp=m.n_mp + torch.sum(ok.to(torch.int32)).to(torch.int32),
    )
    return m, torch.where(ok, slots, torch.full_like(slots, -1))


def observation_mask(m: MapState) -> torch.Tensor:
    """(K, M) bool: keyframe k observes map point j."""
    K, F = m.kf_obs_mp.shape
    M = m.max_mp
    obs = m.kf_obs_mp
    valid = (obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    rows = torch.arange(K, device=obs.device)[:, None].expand(K, F)
    cols = torch.clamp(obs, 0, M - 1).long()
    flat = torch.zeros(K * M, dtype=torch.int32, device=obs.device)
    flat = flat.scatter_reduce(0, (rows * M + cols).reshape(-1),
                               valid.reshape(-1).to(torch.int32),
                               reduce="amax")
    return (flat.view(K, M) > 0) & m.mp_valid[None, :]


def observation_triples(m: MapState, kf_window: torch.Tensor):
    """Flatten the observations of a keyframe window into factor arrays:
    (kf_idx (W*F,), mp_idx (W*F,), uv (W*F,2), octave (W*F,), valid)."""
    W = kf_window.shape[0]
    F = m.n_feat
    kfw = torch.clamp(kf_window, 0, m.max_kf - 1).long()
    win_ok = (kf_window >= 0) & m.kf_valid[kfw]
    obs = m.kf_obs_mp[kfw]
    uv = m.kf_uv[kfw]
    octv = m.kf_octave[kfw]
    fval = m.kf_feat_valid[kfw]
    valid = fval & (obs >= 0) & win_ok[:, None]
    obs_c = torch.clamp(obs, 0, m.max_mp - 1)
    valid = valid & m.mp_valid[obs_c.long()]
    kf_idx = torch.arange(W, dtype=torch.int32,
                          device=obs.device)[:, None].expand(W, F)
    return (kf_idx.reshape(-1), obs_c.reshape(-1), uv.reshape(-1, 2),
            octv.reshape(-1), valid.reshape(-1))


def _front_pack_order(valid: torch.Tensor) -> torch.Tensor:
    """Stable permutation moving valid rows to the front (their relative
    order kept), invalid rows to the tail."""
    N = valid.shape[0]
    key = torch.where(valid, 0, N) + torch.arange(N, device=valid.device)
    return torch.argsort(key)


def _old_to_new(valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, torch.cumsum(valid.to(torch.int32), 0,
                                           dtype=torch.int32) - 1,
                       torch.full_like(valid, -1, dtype=torch.int32))


def compact_map_points(m: MapState) -> Tuple[MapState, torch.Tensor]:
    """Reclaim culled map-point slots by front-packing the valid rows.
    Returns (map, old_to_new (M,) int32 with -1 for dropped rows)."""
    M = m.max_mp
    valid = m.mp_valid
    order = _front_pack_order(valid)
    old_to_new = _old_to_new(valid)

    def g(t):
        return t[order]

    obs = m.kf_obs_mp
    new_obs = torch.where(obs >= 0,
                          old_to_new[torch.clamp(obs, 0, M - 1).long()],
                          torch.full_like(obs, -1))
    m = m._replace(
        mp_pos=g(m.mp_pos), mp_desc=g(m.mp_desc), mp_valid=g(valid),
        mp_normal=g(m.mp_normal), mp_ref_kf=g(m.mp_ref_kf),
        mp_visible=g(m.mp_visible), mp_found=g(m.mp_found),
        mp_first_kf=g(m.mp_first_kf),
        mp_min_dist=g(m.mp_min_dist), mp_max_dist=g(m.mp_max_dist),
        kf_obs_mp=new_obs,
        n_mp=torch.sum(valid.to(torch.int32)).to(torch.int32))
    return m, old_to_new


def compact_keyframes(m: MapState
                      ) -> Tuple[MapState, torch.Tensor, torch.Tensor]:
    """Reclaim culled keyframe slots by front-packing the valid rows; map
    points whose reference (or first) keyframe was dropped are re-homed to
    their first observing keyframe. Returns (map, old_to_new (K,) int32
    with -1 for dropped, order (K,) permutation)."""
    K = m.max_kf
    valid = m.kf_valid
    order = _front_pack_order(valid)
    old_to_new = _old_to_new(valid)

    def g(t):
        return t[order]

    memb = observation_mask(m)                                   # (K, M)
    # argmax of a bool column: its first True row (0 when none)
    first_obs = torch.argmax(memb.to(torch.int8), dim=0).to(torch.int32)
    ref = m.mp_ref_kf
    ref_ok = (ref >= 0) & valid[torch.clamp(ref, 0, K - 1).long()]
    ref2 = torch.where(ref_ok, ref, first_obs)
    new_ref = torch.clamp(old_to_new[torch.clamp(ref2, 0, K - 1).long()],
                          min=0)
    first2 = torch.where(valid[torch.clamp(m.mp_first_kf, 0, K - 1).long()],
                         m.mp_first_kf, first_obs)
    new_first = torch.clamp(
        old_to_new[torch.clamp(first2, 0, K - 1).long()], min=0)

    m = m._replace(
        kf_pose=lie.SE3(g(m.kf_pose.R), g(m.kf_pose.t)),
        kf_valid=g(valid), kf_timestamp=g(m.kf_timestamp),
        kf_uv=g(m.kf_uv), kf_desc=g(m.kf_desc), kf_octave=g(m.kf_octave),
        kf_feat_valid=g(m.kf_feat_valid), kf_obs_mp=g(m.kf_obs_mp),
        mp_ref_kf=new_ref, mp_first_kf=new_first,
        n_kf=torch.sum(valid.to(torch.int32)).to(torch.int32))
    return m, old_to_new, order


def grow_map(m: MapState, new_max_kf: int = 0, new_max_mp: int = 0
             ) -> MapState:
    """Pad the tables to larger capacities (zero or smaller values leave an
    axis unchanged); new keyframe slots hold identity poses."""
    K, M = m.max_kf, m.max_mp
    nK, nM = max(new_max_kf, K), max(new_max_mp, M)
    if nK == K and nM == M:
        return m

    def pad(t, n_new, fill=0):
        if n_new == t.shape[0]:
            return t
        extra = torch.full((n_new - t.shape[0],) + t.shape[1:], fill,
                           dtype=t.dtype, device=t.device)
        return torch.cat([t, extra])

    eye = torch.eye(3, dtype=m.kf_pose.R.dtype, device=m.kf_pose.R.device
                    ).expand(nK - K, 3, 3)
    return m._replace(
        kf_pose=lie.SE3(torch.cat([m.kf_pose.R, eye]), pad(m.kf_pose.t, nK)),
        kf_valid=pad(m.kf_valid, nK), kf_timestamp=pad(m.kf_timestamp, nK),
        kf_uv=pad(m.kf_uv, nK), kf_desc=pad(m.kf_desc, nK),
        kf_octave=pad(m.kf_octave, nK),
        kf_feat_valid=pad(m.kf_feat_valid, nK),
        kf_obs_mp=pad(m.kf_obs_mp, nK, -1),
        mp_pos=pad(m.mp_pos, nM), mp_desc=pad(m.mp_desc, nM),
        mp_valid=pad(m.mp_valid, nM), mp_normal=pad(m.mp_normal, nM),
        mp_ref_kf=pad(m.mp_ref_kf, nM), mp_visible=pad(m.mp_visible, nM),
        mp_found=pad(m.mp_found, nM), mp_first_kf=pad(m.mp_first_kf, nM),
        mp_min_dist=pad(m.mp_min_dist, nM),
        mp_max_dist=pad(m.mp_max_dist, nM, 1e9),
    )


def covisibility_matrix(m: MapState) -> torch.Tensor:
    """(K, K) int32 number of shared map points between keyframes, zero
    diagonal. A float32 product of 0/1 entries, as the reference's: exact,
    since a count cannot exceed the features of one keyframe (< 2^24)."""
    memb = observation_mask(m).to(torch.float32)
    W = (memb @ memb.T).to(torch.int32)
    return W * (1 - torch.eye(W.shape[0], dtype=torch.int32,
                              device=W.device))
