"""PyTorch port parity: the session's capacity management.

The tracker e2e sequence (512 features) with tables far too small for it:
8 keyframe slots and 1,536 map-point slots. Within 40 frames the session
compacts and doubles the map-point table (frame 15), compacts the keyframe
table after a cull (frame 29) and doubles it (frame 34), remapping the
current frame's observations, the last keyframe id and the keyframe-
relative trajectory each time (``MonoTracker._ensure_capacity``).

Held: the JAX ``MonoTracker`` and the port's, both ``loop_closing=False``,
free-running: state, keyframe and map-point counts, table capacities and
the last keyframe id exact on every frame; inlier counts within 1% (a
match on the chi2 threshold can flip with float32 drift, as in
test_torch_session.py); the final trajectories (TUM rows, each frame
resolved through its keyframe) within 1e-3. From the reference's state
carried in just before each capacity event, the port steps the event's
frame exactly: the same counts, capacities and last keyframe id, the
keyframe-relative trajectory's keyframe ids, and the remapped observation
and keyframe tables.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers as h
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import MonoTracker as JTracker
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import MonoTracker, SlamConfig
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.map import convert

# the thread count the free-running readings were taken at (see
# test_torch_session.py)
THREADS = 2
KW = dict(cam_params=(400.0, 400.0, 376.0, 240.0), image_size=(480, 752),
          max_keyframes=8, max_map_points=1536, ba_window=6,
          loop_closing=False)
RENDER = dict(pixel_noise=0.3, desc_bit_flips=3, dropout=0.08, seed=11)
T = 40
EVENTS = (15, 29, 34)      # map-point growth, keyframe compaction, growth


def _port():
    return MonoTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                       device="cpu")


def _step(jt, tt, wj, wt, k):
    rj = jt.process_features(
        jsim.render_frame(wj, k, jnp.asarray(KW["cam_params"]),
                          KW["image_size"], 512, **RENDER),
        float(wj.timestamps[k]))
    rt = tt.process_features(
        tsim.render_frame(wt, k, KW["cam_params"], KW["image_size"], 512,
                          device="cpu", **RENDER), float(wt.timestamps[k]))
    return rj, rt


def _row(tr, rec):
    return (rec.state, int(tr.map.n_kf), int(tr.map.n_mp), tr.map.max_kf,
            tr.map.max_mp, tr.last_kf_id)


@pytest.fixture(scope="module")
def runs():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield _run()
    finally:
        torch.set_num_threads(before)


def _run():
    wj = jsim.make_corridor_world(n_frames=80, n_points=4000, seed=3)
    wt = tsim.make_corridor_world(n_frames=80, n_points=4000, seed=3)
    jt = JTracker(JConfig(orb=JOrb(n_features=512), **KW))
    tt = _port()
    rows, snaps = [], {}
    for k in range(T):
        if k in EVENTS:
            snap = copy.deepcopy(jt)
            snaps[k] = (h.jax_tracker_state(snap), snap)
        rj, rt = _step(jt, tt, wj, wt, k)
        rows.append((_row(jt, rj), _row(tt, rt), rj.tracked, rt.tracked))
    return dict(jt=jt, tt=tt, wj=wj, wt=wt, rows=rows, snaps=snaps)


def test_capacity_events_happen_alike(runs):
    rows = runs["rows"]
    for k, (a, b, nj, nt) in enumerate(rows):
        assert a == b, k
        assert abs(nj - nt) <= 0.01 * nj, (k, nj, nt)
    caps = [a[3:5] for a, _, _, _ in rows]
    assert caps[EVENTS[0] - 1] == (8, 1536) and caps[EVENTS[0]] == (8, 3072)
    assert caps[EVENTS[2] - 1] == (8, 3072) and caps[EVENTS[2]] == (16, 3072)
    # a keyframe was compacted away: the insert left n_kf at the capacity
    assert rows[EVENTS[1]][0][1] == rows[EVENTS[1] - 1][0][1] == 8
    np.testing.assert_allclose(runs["jt"].trajectory_tum(),
                               runs["tt"].trajectory_tum(), atol=1e-3)


@pytest.mark.parametrize("frame", EVENTS)
def test_capacity_event_from_carried_state(runs, frame):
    state, jt = runs["snaps"][frame]
    tt = _port()
    convert.tracker_state_from_numpy(tt, state)
    rj, rt = _step(jt, tt, runs["wj"], runs["wt"], frame)
    assert _row(jt, rj) == _row(tt, rt)
    assert rj.tracked == rt.tracked
    assert [kf for _, kf, _ in jt._traj_rel] == [kf for _, kf, _ in
                                                  tt._traj_rel]
    a = h.jax_map_to_numpy(jt.map)
    b = convert.map_state_to_numpy(tt.map)
    for f in ("kf_valid", "kf_obs_mp", "mp_valid", "mp_ref_kf",
              "mp_first_kf", "mp_found", "mp_visible"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
