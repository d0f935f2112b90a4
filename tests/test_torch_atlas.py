"""Parity: the multi-map atlas (map transform, merge) and the carried
merge and relocalization steps of the atlas sessions, against the JAX
package.

The states come from committed snapshots (``tests/torch_goldens/
atlas_merge_step.pkl.gz`` and ``reloc_step.pkl.gz``, written by
``tests/make_torch_goldens.py``): the reference's ``MonoTracker`` at the
atlas tests' widths (512 features, 12,288 points, 160 keyframe slots,
loop closing on) on ``test_atlas_merge.py``'s circle (blackout 58-67,
``reloc_grace_frames`` 4) just before the frame that welds the active
map into the archived one (frame 73), and on ``test_relocalization.py``'s
arc just before the first frame that relocalizes after a blackout
(frame 44); each with its loop closer, database and atlas, background
solves drained, and the reference's state after that one frame.
* ``transform_map`` and ``merge_maps`` on the snapshot's two maps:
  integer tables exact, floats 1e-5.
* The merge step: record (state, inliers) exact, the atlas emptied, the
  merged map's integer tables and descriptors exact, the database rows
  and loop bookkeeping exact. The weld's Sim3 RANSAC and LM, run by the
  JAX package on the inputs the port gave its own, agree with the port's
  (inliers exact, Sim3 1e-5). The archived map's keyframes keep their
  poses to 1e-4. The welding BA (``local_ba_step`` over the candidate's
  neighbourhood, fixed, and the five welded keyframes) is a flat window
  (ROADMAP C2): its five free keyframes are a freshly welded monocular
  map 0.3 m long, and from the same inputs the two packages' solves part
  by 3.4e-4 in rotation and 0.8 mm in translation, 6 cm on points seen by
  those keyframes alone, at final costs equal to 1e-5 relative (its
  Cholesky fails, and the step is rejected, on different iterations in
  the two). So the welded
  keyframes are held to 1e-3, and the points to 1e-3 for 99% of them and
  0.1 m for all.
* The relocalization step: accepted as the reference's, the inlier count
  exact, the pose 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_helpers as h
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.map import atlas as jatlas
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.engine import MonoTracker
from orb_slam_fusion_tpu_torch.map import atlas as tatlas
from orb_slam_fusion_tpu_torch.map import convert

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def merge_snap():
    return h.load_carried("atlas_merge_step.pkl.gz")


def _S():
    R = h.rot([0.1, -0.2, 0.05])
    t = np.array([0.4, -0.1, 0.2], np.float32)
    return (jlie.Sim3(jnp.float32(1.3), jnp.asarray(R), jnp.asarray(t)),
            tlie.Sim3(torch.tensor(1.3), torch.from_numpy(R),
                      torch.from_numpy(t)))


def test_transform_and_merge_maps(merge_snap):
    before = merge_snap["before"]
    old, new = before["atlas"][0]["map"], before["map"]
    jS, tS = _S()
    h.assert_map_close(
        h.jax_map_to_numpy(jatlas.transform_map(h.jax_map(new), jS)),
        convert.map_state_to_numpy(tatlas.transform_map(
            convert.map_state_from_numpy(new, "cpu"), tS)), atol=1e-5)
    jm, jko, jmo = jatlas.merge_maps(h.jax_map(old), h.jax_map(new), jS)
    tm, tko, tmo = tatlas.merge_maps(
        convert.map_state_from_numpy(old, "cpu"),
        convert.map_state_from_numpy(new, "cpu"), tS)
    assert (jko, jmo) == (tko, tmo) == (int(old["n_kf"]), int(old["n_mp"]))
    h.assert_map_close(h.jax_map_to_numpy(jm), convert.map_state_to_numpy(tm),
                       atol=1e-5)
    # a receiving map without the room refuses, in both
    small = h._untrim_map(dict(h._trim_map(old), max_kf=int(old["n_kf"])))
    assert jatlas.merge_maps(h.jax_map(small), h.jax_map(new), jS)[0] is None
    assert tatlas.merge_maps(convert.map_state_from_numpy(small, "cpu"),
                             convert.map_state_from_numpy(new, "cpu"),
                             tS)[0] is None


def _step(snap, capture=None):
    """The port tracker from the snapshot, one frame on; ``capture``
    (a dict) records the arguments and results of the weld's solvers."""
    import orb_slam_fusion_tpu_torch.solver.local_ba as tlba
    import orb_slam_fusion_tpu_torch.solver.sim3 as tsim3
    saved = []
    if capture is not None:
        for mod, name in ((tsim3, "sim3_ransac"), (tsim3, "optimize_sim3"),
                          (tlba, "local_ba_step")):
            fn = getattr(mod, name)

            def rec_call(*a, _fn=fn, _name=name, **k):
                out = _fn(*a, **k)
                capture.setdefault(_name, []).append((a, k, out))
                return out
            saved.append((mod, name, fn))
            setattr(mod, name, rec_call)
    try:
        tr = MonoTracker(chip_smoke._config(snap["config"]), device="cpu")
        convert.tracker_state_from_numpy(tr, snap["before"])
        rec = h.with_threads(2, lambda: tr.process_features(
            convert.features_from_numpy(snap["inputs"], "cpu"),
            snap["timestamp"]))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    # the reference's state after the frame was read with its background
    # solves drained
    tr._lba_drain()
    tr.loop_closer.gba_drain(tr)
    return tr, rec


def _jx(x):
    return jnp.asarray(x.numpy()) if torch.is_tensor(x) else x


def _weld_solvers_match_reference(cap):
    from orb_slam_fusion_tpu.solver import local_ba as jlba
    from orb_slam_fusion_tpu.solver import sim3 as jsim3
    # every candidate the merge tried (the last one welded)
    for a, k, rt in cap["sim3_ransac"]:
        rj = jsim3.sim3_ransac(*[_jx(x) for x in a[:6]], jnp.asarray(a[6]),
                               **k)
        assert bool(rj.ok) == bool(rt.ok)
        np.testing.assert_array_equal(rt.inliers.numpy(),
                                      np.asarray(rj.inliers))
        for x, y in zip(rj.sim, rt.sim):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)
    for a, k, ot in cap["optimize_sim3"]:
        oj = jsim3.optimize_sim3(jlie.Sim3(*[_jx(x) for x in a[0]]),
                                 *[_jx(x) for x in a[1:9]], **k)
        np.testing.assert_array_equal(ot[1].numpy(), np.asarray(oj[1]))
        for x, y in zip(oj[0], ot[0]):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)
    # the welding BA from the same inputs: the same observations and costs
    (a, k, lt), = cap["local_ba_step"]
    lj = jlba.local_ba_step(h.jax_map(convert.map_state_to_numpy(a[0])),
                            *[_jx(x) for x in a[1:5]], **k)
    np.testing.assert_array_equal(lt[0].kf_obs_mp.numpy(),
                                  np.asarray(lj[0].kf_obs_mp))
    # the first candidates and the final cost; between them the flat
    # system's Cholesky fails (a rejected step) on different iterations
    ct, cj = lt[1].numpy(), np.asarray(lj[1])
    np.testing.assert_allclose(ct[:3], cj[:3], rtol=1e-4)
    np.testing.assert_allclose(ct[-1], cj[-1], rtol=1e-4)


def _pose_close(a, T, atol=1e-4):
    np.testing.assert_allclose(T.R.numpy(), a[0], atol=atol)
    np.testing.assert_allclose(T.t.numpy(), a[1], atol=atol)


def test_carried_merge_step(merge_snap):
    snap = merge_snap
    after = snap["after"]
    cap = {}
    tr, rec = _step(snap, cap)
    assert rec.state == snap["rec"]["state"]
    assert int(rec.tracked) == snap["rec"]["tracked"]
    assert len(tr.atlas) == len(after["atlas"]) == 0
    _weld_solvers_match_reference(cap)
    mt = convert.map_state_to_numpy(tr.map)
    am = after["map"]
    h.assert_live_tables(am, mt, skip=("kf_pose", "mp_pos"))
    ko = int(snap["before"]["atlas"][0]["map"]["n_kf"])
    n = int(am["n_kf"])
    for x, y in zip(am["kf_pose"], mt["kf_pose"]):
        np.testing.assert_allclose(y[:ko], x[:ko], atol=1e-4)
        np.testing.assert_allclose(y[ko:n], x[ko:], atol=1e-3)
    d = np.abs(mt["mp_pos"][:int(am["n_mp"])] - am["mp_pos"]).max(axis=1)
    assert np.mean(d <= 1e-3) >= 0.99 and d.max() < 0.1, (np.mean(
        d <= 1e-3), d.max())
    _pose_close(after["cur_pose"], tr.cur_pose, 1e-3)
    assert tr.last_kf_id == after["last_kf_id"]
    assert tr._merge_cooldown == after["merge_cooldown"]
    lc, alc = tr.loop_closer, after["loop_closer"]
    np.testing.assert_array_equal(lc.db.present.numpy()[:n], alc["present"])
    assert not lc.db.present.numpy()[n:].any()
    np.testing.assert_allclose(lc.db.bow.numpy()[:n], alc["bow"], atol=1e-6)
    assert [e[:2] for e in lc.loop_edges] == [
        tuple(e[:2]) for e in alc["loop_edges"]]
    assert lc.last_loop_kf == alc["last_loop_kf"]
    assert [kf for _, kf, _ in tr._traj_rel] == [
        kf for _, kf, _ in after["traj_rel"]]


def test_carried_relocalization_step():
    snap = h.load_carried("reloc_step.pkl.gz")
    assert snap["before"]["state"] == "LOST"
    tr, rec = _step(snap)
    assert rec.state == snap["rec"]["state"] == "ok"
    assert int(rec.tracked) == snap["rec"]["tracked"]
    _pose_close(snap["rec"]["pose"], rec.pose)
    assert int(tr.map.n_kf) == int(snap["after"]["map"]["n_kf"])
    assert len(tr.atlas) == 0
