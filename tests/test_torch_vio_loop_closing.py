"""Parity: inertial loop closures of the stereo-inertial atlas session,
carried from the reference's state, against the JAX package.

The states come from a committed snapshot (``tests/torch_goldens/
vio_loop_closures.pkl.gz``, written by ``tests/make_torch_goldens.py``
during the run that writes ``stereo_vio_atlas_session_480x752.json``): the
reference's ``StereoVioTracker(SlamConfig(), 0.11, make_calib())`` on
``test_inertial_merge.py``'s circle, as its ``LoopCloser.try_close`` saw
it on the keyframes that close the merged map's third and fourth loops
(frames 118 and 133; the port's free-running run parts from the golden on
frame 22 and does not reach them, PERF.md §6). The IMU is initialized
there, so the Sim3 search fixes the scale and the correction is the 4-DoF
pose graph (yaw and translation). The in-flight local and global BA are
dropped as the correction drops them; their scattered iterates are in the
map already.

Held exactly: that the call closes, the funnel counters (the best BoW
score, a float sum, to 1e-6), the consistency groups, the detection it
dispatches (candidate ids and groups; scores to 1e-6), the loop edges'
endpoints, the point tables' integer fields after the duplicate fusion,
and that a global BA starts. The new loop edge's Sim3 to 1e-4 with its
scale exactly 1; the corrected keyframe poses and the live pose to 1e-4;
the map points to 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_helpers as h
from orb_slam_fusion_tpu_torch.engine import StereoVioTracker
from orb_slam_fusion_tpu_torch.imu.preintegration import make_calib
from orb_slam_fusion_tpu_torch.map import convert

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def snap():
    return h.load_pickle("vio_loop_closures.pkl.gz")


def _closed(snap, i):
    c = snap["closures"][i]
    tr = StereoVioTracker(chip_smoke._config(snap["config"]),
                          chip_smoke.VIO_BASELINE, make_calib(device="cpu"),
                          device="cpu")
    convert.tracker_state_from_numpy(tr, h.untrim_state(c["before"]))
    assert tr.imu_initialized and len(tr.atlas) == 0
    assert tr.loop_closer.num_closed == c["closed"] - 1
    fired = h.with_threads(2, lambda: tr.loop_closer.try_close(tr))
    return c, tr, fired


@pytest.mark.parametrize("i", [0, 1])
def test_carried_inertial_loop_closure(snap, i):
    c, tr, fired = _closed(snap, i)
    want = c["after"]
    lc, wl = tr.loop_closer, want["loop_closer"]
    assert fired
    assert lc.num_closed == wl["num_closed"] == c["closed"]
    assert lc.last_loop_kf == wl["last_loop_kf"]
    assert sorted(lc.stats) == sorted(wl["stats"])
    for key, v in wl["stats"].items():
        if key == "best_score_max":
            assert abs(lc.stats[key] - v) < 1e-6
        else:
            assert lc.stats[key] == v, key
    assert [(sorted(g), n) for g, n in lc._cons_groups] == [
        (sorted(g), n) for g, n in wl["cons_groups"]]
    pd, wpd = lc._pending_detect, wl["pending_detect"]
    assert (pd is None) == (wpd is None)
    if pd is not None:
        assert pd[0] == wpd[0]
        np.testing.assert_array_equal(pd[1].numpy(), wpd[1])
        np.testing.assert_array_equal(pd[2].numpy(), wpd[2])
        np.testing.assert_allclose(pd[3].numpy(), wpd[3], atol=1e-6)
    assert [e[:2] for e in lc.loop_edges] == [
        tuple(e[:2]) for e in wl["loop_edges"]]
    s, R, t = (x.numpy() for x in lc.loop_edges[-1][2])
    ws, wR, wt = wl["loop_edges"][-1][2]
    assert float(s) == float(ws) == 1.0          # fix_scale: the IMU is up
    np.testing.assert_allclose(R, wR, atol=1e-4)
    np.testing.assert_allclose(t, wt, atol=1e-4)
    assert (lc.pending_gba is not None) == want["gba"]
    am = want["map"]
    K, M = int(am["n_kf"]), int(am["n_mp"])
    mt = convert.map_state_to_numpy(tr.map)
    assert (int(mt["n_kf"]), int(mt["n_mp"])) == (K, M)
    for f in ("kf_obs_mp", "kf_valid"):
        np.testing.assert_array_equal(mt[f][:K], am[f], err_msg=f)
    for f in ("mp_valid", "mp_ref_kf"):
        np.testing.assert_array_equal(mt[f][:M], am[f], err_msg=f)
    np.testing.assert_allclose(tr.map.kf_pose.R.numpy()[:K], am["kf_pose"][0],
                               atol=1e-4)
    np.testing.assert_allclose(tr.map.kf_pose.t.numpy()[:K], am["kf_pose"][1],
                               atol=1e-4)
    np.testing.assert_allclose(tr.cur_pose.R.numpy(), want["cur_pose"][0],
                               atol=1e-4)
    np.testing.assert_allclose(tr.cur_pose.t.numpy(), want["cur_pose"][1],
                               atol=1e-4)
    np.testing.assert_allclose(mt["mp_pos"][:M], am["mp_pos"], atol=1e-4,
                               rtol=1e-4)
