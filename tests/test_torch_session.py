"""PyTorch port parity: the monocular session (``MonoTracker``) end to end.

JAX's ``MonoTracker`` and the port's, both with ``loop_closing=False``, on
the ``tests/test_tracker_e2e.py`` sequence (corridor world seed 3, 80
frames, 480x752, 512 features, 4096 map points, ``ba_window`` 6), each fed
its own package's ``sim.render_frame`` (bit-identical inputs).

What holds exactly, and why the rest is held to a tolerance:

* Carried state, one step at a time: the reference's state at frames 20,
  41 and 60 (a background local BA in flight drained first, on a copy)
  is loaded into the port with ``convert.tracker_state_from_numpy``, and
  both step the next two frames: state, inlier count, keyframe and
  map-point counts and the integer map tables exact; the pose atol 1e-4.
  This pins every decision of the session to the reference's.
* Free-running, the two sessions see the same states on every frame, the
  same init frame and init inlier count, and the same tracked count. The
  per-frame inlier counts agree exactly until float32 drift flips a
  decision: the two packages round the local BA differently (ROADMAP C2:
  a barely constrained landmark moves by rounding alone), keyframe poses
  drift apart, and a match whose chi2 sits on the inlier threshold flips,
  or a keyframe decision. Where depends on
  the port's own rounding: at the 2 torch threads this file pins, the
  first differing frame is 71 (9 of 80 differ); at 4 threads it is 41
  (``tests/torch_session_spread.py compare --e2e``). So: inlier counts
  exact on >= 80% of the frames and within 5% on every frame; final
  keyframe count within 2 and map points within 5%; ATE within 0.5 mm of
  the reference's (both ~2.7 mm, the e2e gate is 3 cm).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers as h
from torch_regime import pinned
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import MonoTracker as JTracker
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu.io import ate_rmse
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import MonoTracker, SlamConfig
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.map import convert

# every test file sets the process-wide thread count when it is imported;
# the sessions pin theirs while they run, since the port's float32 sums
# (and so where a free-running session parts from the reference) depend
# on it
THREADS = 2

KW = dict(cam_params=(400.0, 400.0, 376.0, 240.0), image_size=(480, 752),
          max_keyframes=64, max_map_points=4096, ba_window=6,
          loop_closing=False)
RENDER = dict(pixel_noise=0.3, desc_bit_flips=3, dropout=0.08, seed=11)
T = 80
CARRY_AT = (20, 41, 60)
STEPS = 2


def _jax_frame(world, k):
    return jsim.render_frame(world, k, jnp.asarray(KW["cam_params"]),
                             KW["image_size"], 512, **RENDER)


def _port_frame(world, k):
    return tsim.render_frame(world, k, KW["cam_params"], KW["image_size"],
                             512, device="cpu", **RENDER)


def _row(tr, rec):
    return (rec.state, int(rec.tracked), int(tr.map.n_kf),
            int(tr.map.n_mp))


def _ate(tr, states, gt):
    start = states.index("init-done")
    traj = tr.trajectory_tum()
    return float(ate_rmse(traj[start:, 1:4], gt[start:len(traj)]))


@pytest.fixture(scope="module")
def runs():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield _run()
    finally:
        torch.set_num_threads(before)


def _run():
    wj = jsim.make_corridor_world(n_frames=T, n_points=4000, seed=3)
    wt = tsim.make_corridor_world(n_frames=T, n_points=4000, seed=3)
    jt = JTracker(JConfig(orb=JOrb(n_features=512), **KW))
    tt = MonoTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                     device="cpu")
    log_j, log_t, snaps = [], [], {}
    for k in range(T):
        if k in CARRY_AT:
            snap = copy.deepcopy(jt)
            snaps[k] = (h.jax_tracker_state(snap), snap)
        rj = jt.process_features(_jax_frame(wj, k), float(wj.timestamps[k]))
        log_j.append(_row(jt, rj))
        rt = tt.process_features(_port_frame(wt, k), float(wt.timestamps[k]))
        log_t.append(_row(tt, rt))
    gt = tsim.gt_positions(wt)
    ate_j = _ate(jt, [r[0] for r in log_j], gt)
    ate_t = _ate(tt, [r[0] for r in log_t], gt)
    return dict(wj=wj, wt=wt, log_j=log_j, log_t=log_t, snaps=snaps,
                ate=(ate_j, ate_t))


@pinned
@pytest.mark.parametrize("frame", CARRY_AT)
def test_carried_state_steps_match(runs, frame):
    state, jt = runs["snaps"][frame]
    tt = MonoTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                     device="cpu")
    convert.tracker_state_from_numpy(tt, state)
    for k in range(frame, frame + STEPS):
        rj = jt.process_features(_jax_frame(runs["wj"], k),
                                 float(runs["wj"].timestamps[k]))
        rt = tt.process_features(_port_frame(runs["wt"], k),
                                 float(runs["wt"].timestamps[k]))
        assert _row(jt, rj) == _row(tt, rt), k
        np.testing.assert_allclose(np.asarray(jt.cur_pose.R),
                                   tt.cur_pose.R.numpy(), atol=1e-4)
        np.testing.assert_allclose(np.asarray(jt.cur_pose.t),
                                   tt.cur_pose.t.numpy(), atol=1e-4)
        a = h.jax_map_to_numpy(jt.map)
        b = convert.map_state_to_numpy(tt.map)
        for f in ("kf_valid", "kf_obs_mp", "mp_valid", "mp_visible",
                  "mp_found", "n_kf", "n_mp"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{k} {f}")
        assert jt.frames_since_kf == tt.frames_since_kf
        assert jt.last_kf_id == tt.last_kf_id


@pinned
def test_session_states_and_tracking(runs):
    lj, lt = runs["log_j"], runs["log_t"]
    assert [r[0] for r in lj] == [r[0] for r in lt]
    start = [r[0] for r in lj].index("init-done")
    assert lj[start][1] == lt[start][1]
    assert sum(r[0] in ("ok", "init-done") for r in lt) > 60


@pinned
def test_session_counts_within_drift(runs):
    lj, lt = runs["log_j"], runs["log_t"]
    same = sum(a[1] == b[1] for a, b in zip(lj, lt))
    assert same >= 0.8 * T, same
    for k, (a, b) in enumerate(zip(lj, lt)):
        assert abs(a[1] - b[1]) <= 0.05 * a[1], (k, a, b)
    assert abs(lj[-1][2] - lt[-1][2]) <= 2
    assert abs(lj[-1][3] - lt[-1][3]) <= 0.05 * lj[-1][3]


@pinned
def test_session_ate(runs):
    ate_j, ate_t = runs["ate"]
    assert ate_t < 0.03
    assert abs(ate_j - ate_t) < 5e-4, (ate_j, ate_t)


def test_constructor_refuses_unported_modes():
    # loop closing (A13) is ported: SlamConfig() as is builds a loop closer
    # whose database and seeded vocabulary are the reference's
    from orb_slam_fusion_tpu.place import make_vocabulary as j_vocab
    tr = MonoTracker(SlamConfig(), device="cpu")
    lc = tr.loop_closer
    assert lc is not None and tr.enable_atlas and len(tr.atlas) == 0
    assert tuple(lc.db.bow.shape) == (256, 4096)
    np.testing.assert_array_equal(
        lc.db.vocab.words.numpy().view(np.uint32),
        np.asarray(j_vocab(4096).words))
    # A15 is ported: mesh_devices on a CPU tracker builds a mesh of that
    # many CPU shards (no refusal); without it there is no mesh
    tr = MonoTracker(SlamConfig(loop_closing=False, mesh_devices=2),
                     device="cpu")
    assert tr.mesh is not None and tr.mesh.shape == {"mp": 2}
    assert [d.type for d in tr.mesh.devices] == ["cpu", "cpu"]
    assert MonoTracker(SlamConfig(loop_closing=False),
                       device="cpu").mesh is None
    # A11 is ported: a radial-tangential distortion undistorts keypoints
    # (held to the reference in tests/test_torch_cameras_kb8.py); only an
    # unknown camera model is refused
    tr = MonoTracker(SlamConfig(loop_closing=False,
                                distortion=(0.1, 0, 0, 0)), device="cpu")
    uv = torch.tensor([[600.0, 400.0]])
    f = convert.features_from_numpy(dict(
        uv=uv.numpy(), response=np.ones(1, np.float32),
        octave=np.zeros(1, np.int32), angle=np.zeros(1, np.float32),
        desc=np.zeros((1, 8), np.uint32), valid=np.ones(1, bool)), "cpu")
    assert not torch.equal(tr._undistort(f).uv, uv)
    with pytest.raises(ValueError, match="camera model"):
        MonoTracker(SlamConfig(loop_closing=False, cam_model="equirect"),
                    device="cpu")
