"""PyTorch port parity: the stereo session (``StereoTracker``) on the
``tests/test_stereo_e2e.py`` sequence (corridor world seed 7, baseline
0.11 m, 480x752, 512 features, 6144 map points, ``ba_window`` 6).

* Carried state: the reference runs to frame 12 (its background local BA
  drained), the port takes over its state with
  ``convert.tracker_state_from_numpy`` (``kf_uright`` included) and both
  step two frames, the second inserting a keyframe whose local BA carries
  stereo factors: state, inliers, keyframe and map-point counts, the
  integer map tables and the right-image u table exact, the pose within
  1e-4.
* Free-running, the port's session over the sequence's first 30 frames
  is held to the reference's committed golden run
  (``tests/torch_goldens/stereo_e2e_session_480x752.json``, written by
  ``tests/make_torch_goldens.py``), so the reference does not run here:
  the same input hashes and the same state on every frame, inlier counts
  exact on >= 80% of the frames and within 5% on all, keyframes within 2
  and map points within 5% at the end, the metric ATE (no alignment)
  under the e2e test's 0.08 m and within 5 mm of the golden's over the
  same frames, and every position within 2 cm of the golden's (whose
  poses took 40 more frames of local BA corrections; the newest
  keyframes' move by ~1 cm). Exactness is not expected over a
  whole run: the background local BA amplifies float32 differences
  (ROADMAP C2); on this sequence the two runs kept identical per-frame
  rows through frame 24 (CPU, 2 torch threads).
"""

import copy
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
import test_torch_helpers as h
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.engine.stereo_tracker import StereoTracker as JStereo
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import SlamConfig
from orb_slam_fusion_tpu_torch.engine.stereo_tracker import StereoTracker
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.io import ate_rmse
from orb_slam_fusion_tpu_torch.map import convert

THREADS = 2
KW = dict(cam_params=(400.0, 400.0, 376.0, 240.0), image_size=(480, 752),
          max_keyframes=64, max_map_points=6144, ba_window=6,
          loop_closing=False)
RENDER = dict(pixel_noise=0.3, desc_bit_flips=3, dropout=0.08, seed=31)
BASELINE = 0.11
CARRY_AT, STEPS = 12, 2
FREE_FRAMES = 30
GOLDEN = (pathlib.Path(__file__).resolve().parent / "torch_goldens"
          / "stereo_e2e_session_480x752.json")


def _row(tr, rec):
    return (rec.state, int(rec.tracked), int(tr.map.n_kf), int(tr.map.n_mp))


def _port_tracker():
    return StereoTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                         baseline=BASELINE, device="cpu")


def _port_pair(world, k):
    return tsim.render_stereo_frame(world, k, KW["cam_params"],
                                    KW["image_size"], 512, BASELINE,
                                    device="cpu", **RENDER)


def test_stereo_steps_from_carried_state():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        wj = jsim.make_corridor_world(n_frames=70, n_points=5000, seed=7)
        wt = tsim.make_corridor_world(n_frames=70, n_points=5000, seed=7)
        jt = JStereo(JConfig(orb=JOrb(n_features=512), **KW),
                     baseline=BASELINE)

        def jpair(k):
            return jsim.render_stereo_frame(
                wj, k, jnp.asarray(KW["cam_params"]), KW["image_size"], 512,
                BASELINE, **RENDER)

        for k in range(CARRY_AT):
            jt.process_stereo_features(*jpair(k), float(wj.timestamps[k]))
        snap = copy.deepcopy(jt)
        state = h.jax_tracker_state(snap)
        assert state["kf_uright"] is not None
        tt = _port_tracker()
        convert.tracker_state_from_numpy(tt, state)
        n_kf0 = int(tt.map.n_kf)
        for k in range(CARRY_AT, CARRY_AT + STEPS):
            rj = snap.process_stereo_features(*jpair(k),
                                              float(wj.timestamps[k]))
            rt = tt.process_stereo_features(*_port_pair(wt, k),
                                            float(wt.timestamps[k]))
            assert _row(snap, rj) == _row(tt, rt), k
            np.testing.assert_allclose(np.asarray(snap.cur_pose.t),
                                       tt.cur_pose.t.numpy(), atol=1e-4)
            np.testing.assert_allclose(np.asarray(snap.cur_pose.R),
                                       tt.cur_pose.R.numpy(), atol=1e-4)
            a = h.jax_map_to_numpy(snap.map)
            b = convert.map_state_to_numpy(tt.map)
            for f in ("kf_valid", "kf_obs_mp", "mp_valid", "mp_visible",
                      "mp_found", "n_kf", "n_mp"):
                np.testing.assert_array_equal(a[f], b[f], err_msg=f"{k} {f}")
            np.testing.assert_array_equal(
                np.asarray(snap.kf_uright).view(np.int32),
                tt.kf_uright.numpy().view(np.int32))
            assert snap.frames_since_kf == tt.frames_since_kf
            assert snap.last_kf_id == tt.last_kf_id
        assert int(tt.map.n_kf) > n_kf0, "no keyframe inserted in the steps"
    finally:
        torch.set_num_threads(before)


def test_free_running_session_against_golden():
    g = json.loads(GOLDEN.read_text())
    assert g["world"] == chip_smoke.STEREO_WORLD
    assert g["baseline"] == BASELINE
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        world = tsim.make_corridor_world(**g["world"])
        tt = _port_tracker()
        rows = []
        for k in range(FREE_FRAMES):
            a = tsim.render_stereo_frame_numpy(
                world, k, KW["cam_params"], KW["image_size"], 512, BASELINE,
                **RENDER)
            assert chip_smoke._sha(*(v for f in a for v in f.values())) \
                == g["frames"][k]["inputs_sha256"], k
            rec = tt.process_stereo_features(
                *(tsim.features_on(f, "cpu") for f in a),
                float(world.timestamps[k]))
            rows.append(_row(tt, rec))
    finally:
        torch.set_num_threads(before)
    gold = [(f["state"], f["tracked"], f["n_kf"], f["n_mp"])
            for f in g["frames"][:FREE_FRAMES]]
    assert [r[0] for r in rows] == [r[0] for r in gold]
    assert rows[0] == gold[0]
    exact = sum(r[1] == q[1] for r, q in zip(rows, gold))
    assert exact >= 0.8 * FREE_FRAMES, (rows, gold)
    assert all(abs(r[1] - q[1]) <= 0.05 * q[1] for r, q in zip(rows, gold))
    assert abs(rows[-1][2] - gold[-1][2]) <= 2
    assert abs(rows[-1][3] - gold[-1][3]) <= 0.05 * gold[-1][3]
    traj = tt.trajectory_tum()[:, 1:4]
    want = np.asarray(g["trajectory_tum"])[:FREE_FRAMES, 1:4]
    assert np.abs(traj - want).max() < 2e-2
    gt = tsim.gt_positions(world)[:FREE_FRAMES]
    ate = ate_rmse(traj, gt, with_scale=False)
    assert ate < 0.08 and abs(ate - ate_rmse(want, gt, with_scale=False)) \
        < 5e-3


def test_rotation_drift_guard():
    """The live pose is re-orthonormalized (the JAX package's
    ``so3_normalize``, through the unit quaternion) only once its rotation
    has drifted past ``ROTATION_DRIFT_TOL`` (ROADMAP C6): a pose within
    float32 rounding of SO(3) keeps its bits, a drifted one comes back to
    SO(3) and moves by less than the drift it removes."""
    from orb_slam_fusion_tpu_torch import lie as tlie
    from orb_slam_fusion_tpu_torch.engine.tracker import keep_on_so3
    R = torch.from_numpy(h.rot([0.3, -0.2, 0.5]))
    t = torch.tensor([0.1, -0.2, 0.3])
    T = tlie.SE3(R, t)
    assert keep_on_so3(T) is T
    E = torch.tensor([[2.0, 1.0, 0.0], [1.0, -1.0, 0.5], [0.0, 0.5, 1.0]])
    bent = tlie.SE3(R @ (torch.eye(3) + 1e-3 * E), t)
    drift = float(tlie.so3_orthonormality_error(bent.R))
    assert drift > 1e-4
    fixed = keep_on_so3(bent)
    assert float(tlie.so3_orthonormality_error(fixed.R)) < 1e-6
    assert torch.equal(fixed.t, t)
    assert float(torch.abs(fixed.R - R).max()) < drift
