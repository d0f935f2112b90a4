"""Parity: the port's LoopCloser on ``test_loop_closing_e2e.py``'s maps,
against the JAX package's closer on the same maps.

The 20-keyframe circle with compounding rigid drift (its tail revisiting
the head with duplicated points) and the aliased corridor are built by the
JAX package's own test code; ``tests/make_torch_goldens.py`` carries them
into numpy (``loop_map_20kf.npz``, and the corridor in
``loop_closer_steps.pkl.gz``) together with the reference closer's record
of every ``try_close`` on the tail keyframes, fed one by one through that
test's facade tracker (``tests/test_torch_goldens.py`` holds the carried
maps and the tree vocabulary to what the JAX package builds today). The
port's closer gets the same database and the same keyframes. Held exactly
after every ``try_close``: its result, the pending detection's candidate
ids and groups, the consistency groups, the ``stats`` funnel counters
(the best BoW score, a float, to 1e-6) and the loop edges' endpoints; the
closing Sim3 to 1e-4; the keyframe poses after the correction (pose graph,
point re-mapping and duplicate fusion) and after the drained global BA to
1e-3 m, the point tables' integer fields exactly. Variants: the flat
seeded vocabulary, a tree vocabulary trained and saved by the JAX package
(the port loads the same file), and the aliased single hit that must not
close.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_helpers as h
import torch_fixtures
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.io import evaluation
from orb_slam_fusion_tpu_torch.map import convert

torch.set_num_threads(1)
CAM = (400.0, 400.0, 376.0, 240.0)       # test_loop_closing_e2e.CAM


@pytest.fixture(scope="module")
def rec():
    return h.load_pickle("loop_closer_steps.pkl.gz")


LOOP_MAP = os.path.join(chip_smoke.GOLDEN_DIR, chip_smoke.LOOP_MAP_FILE)


def _same_stats(sj, st, k):
    """The funnel counters exactly; the best BoW score (a float sum)
    within 1e-6."""
    assert sorted(sj) == sorted(st), k
    for key in sj:
        if key == "best_score_max":
            assert abs(st[key] - sj[key]) < 1e-6, k
        else:
            assert st[key] == sj[key], (k, key)


def _drive(tt, ct, K, r):
    """The e2e test's drive_loop_closer on the port, held to the
    reference's record step by step. Returns whether it closed."""
    np.testing.assert_allclose(ct.db.bow.numpy()[:K], r["bow"], atol=1e-6)
    np.testing.assert_array_equal(ct.db.present.numpy()[:K], r["present"])
    closed = False
    for want in r["steps"]:
        k = want["k"]
        tt.last_kf_id = k
        tt.cur_pose = tlie.SE3(tt.map.kf_pose.R[k], tt.map.kf_pose.t[k])
        got = ct.try_close(tt)
        assert got == want["fired"], k
        closed = closed or got
        _same_stats(want["stats"], ct.stats, k)
        assert [(sorted(g), c) for g, c in ct._cons_groups] == \
            want["cons_groups"], k
        assert (ct._pending_detect is None) == (want["pending"] is None), k
        if want["pending"] is not None:
            for i, w in zip((1, 2), want["pending"]):
                np.testing.assert_array_equal(
                    ct._pending_detect[i].numpy(), w)
        assert [e[:2] for e in ct.loop_edges] == [
            e[:2] for e in want["edges"]], k
        for (_, _, sj), (_, _, st) in zip(want["edges"], ct.loop_edges):
            for a, b in zip(sj, st):
                np.testing.assert_allclose(b.numpy(), a, atol=1e-4)
        if got:
            # right after the correction (before the GBA completes)
            mj = want["map"]
            mt = convert.map_state_to_numpy(tt.map)
            np.testing.assert_allclose(tt.map.kf_pose.R.numpy()[:K],
                                       mj["kf_pose"][0], atol=1e-3)
            np.testing.assert_allclose(tt.map.kf_pose.t.numpy()[:K],
                                       mj["kf_pose"][1], atol=1e-3)
            M = int(mj["n_mp"])
            for f in ("n_kf", "n_mp"):
                assert int(mt[f]) == int(mj[f]), f
            np.testing.assert_array_equal(mt["kf_obs_mp"][:K],
                                          mj["kf_obs_mp"])
            np.testing.assert_array_equal(mt["mp_valid"][:M], mj["mp_valid"])
            np.testing.assert_allclose(mt["mp_pos"][:M], mj["mp_pos"],
                                       atol=1e-3, rtol=1e-4)
    ct.gba_drain(tt)
    np.testing.assert_allclose(tt.map.kf_pose.R.numpy()[:K], r["final_R"],
                               atol=1e-3)
    np.testing.assert_allclose(tt.map.kf_pose.t.numpy()[:K], r["final_t"],
                               atol=1e-3)
    return closed


def _ate(tt, z, K):
    R, t = tt.map.kf_pose.R.numpy(), tt.map.kf_pose.t.numpy()
    centers = np.stack([-R[k].T @ t[k] for k in range(K)])
    gtc = np.stack([-z["gt_R"][k].T @ z["gt_t"][k] for k in range(K)])
    return float(evaluation.ate_rmse(centers, gtc, with_scale=False))


def test_loop_detect_and_correct(rec):
    tt, ct, z = torch_fixtures.load_loop_map(LOOP_MAP, "cpu")
    K = int(tt.map.n_kf)
    assert h.with_threads(2, lambda: _drive(tt, ct, K, rec["flat"]))
    assert len(ct.loop_edges) == 1
    assert _ate(tt, z, K) < 0.25


def test_loop_closing_with_tree_vocabulary(rec, tmp_path):
    voc = tmp_path / "voc.bin"
    voc.write_bytes(rec["tree_vocab_bin"])
    tt, ct, z = torch_fixtures.load_loop_map(LOOP_MAP, "cpu",
                                             vocab_path=str(voc))
    K = int(tt.map.n_kf)
    assert ct.db.levels == 3
    assert h.with_threads(2, lambda: _drive(tt, ct, K, rec["tree"]))
    assert _ate(tt, z, K) < 0.25


def test_aliased_single_hit_rejected(rec):
    """The e2e test's aliased corridor (built with its code, carried): the
    port's closer records the reference's steps and never closes."""
    c = rec["aliased_cfg"]
    tt, ct = torch_fixtures.loop_pair(
        rec["aliased_map"], CAM, c["n_feat"], c["max_keyframes"],
        c["max_map_points"], "cpu", vocab_words=2048)
    K = int(tt.map.n_kf)
    assert not h.with_threads(2, lambda: _drive(tt, ct, K, rec["aliased"]))
    assert ct.num_closed == 0
