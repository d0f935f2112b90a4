"""PyTorch port parity: the monocular session fed images (``process_image``).

The ``tests/test_image_e2e.py`` sequence: the gentle world, 50 rendered
240x376 images, 512 features, ``init_min_matches`` 50 and
``init_min_inliers`` 35, ``loop_closing=False``, through each package's
own ``sim.render_image`` (bit-identical images) and extractor (bit-exact,
angles included: ROADMAP C4).

Held: both sessions pass that test's gates (init within the first 25
frames, >= 75% of the frames after init tracked, ATE < 0.5 m); they
initialize on the same frame with the same inlier count and agree on
every frame's state, inlier, keyframe and map-point counts for the first
five tracked frames. From the reference's state carried in at frame 22
(the last frame before the free-running sessions first differ), the port
steps the next two frames as the reference does, and the keyframe's
mapping step replays exactly from identical inputs; from its state on
the frame where it first loses track, the port loses track there too and
fails to relocalize on the next two frames as the reference does. Later,
float32 drift in local BA (ROADMAP C2), amplified by the background local
BA, changes map-point counts and the sessions part: on this sequence the
reference tracks 27 frames, the port 29 at the 2 CPU threads this test
pins and 35 at 8 threads (and on the card). Perturbed by 1e-5 just after
init, the reference itself tracks 25-30 frames and the port 23-35
(``tests/torch_session_spread.py --image``; PERF.md, PR 6); with
synchronous local BA the two agree on every frame
(``tests/test_torch_image_session_sync.py``). Which frame the reference
loses track on moves with the host's library kernels (frame 42 in the
pinned regime, 40 on OpenBLAS's SkylakeX core), so the tests run in the
pinned regime (``torch_regime.PINNED``, ROADMAP C13) and the loss case
takes the frame from the reference's run.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers as h
from torch_regime import pinned
from chip_smoke import _gentle_positions
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import MonoTracker as JTracker
from orb_slam_fusion_tpu.engine import mapping as jmapping
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu.io import ate_rmse
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import MonoTracker, SlamConfig
from orb_slam_fusion_tpu_torch.engine import mapping as tmapping
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.map import convert

# every test file sets the process-wide thread count when it is imported;
# the sessions pin theirs while they run, since the port's float32 sums
# (and so where a free-running session parts from the reference) depend
# on it
THREADS = 2

CAM = (300.0, 300.0, 188.0, 120.0)
H, W, T = 240, 376, 50
KW = dict(cam_params=CAM, image_size=(H, W), ba_window=6,
          loop_closing=False, init_min_matches=50, init_min_inliers=35)
CARRY_AT = 22


def _row(tr, rec):
    return (rec.state, int(rec.tracked), int(tr.map.n_kf),
            int(tr.map.n_mp))


def _gates(tr, states, gt):
    assert "init-done" in states, states[:15]
    start = states.index("init-done")
    assert start < T // 2, start
    ok = sum(s in ("ok", "init-done") for s in states)
    assert ok >= int((T - start) * 0.75), (ok, states)
    traj = tr.trajectory_tum()
    ate = float(ate_rmse(traj[start:, 1:4], gt[start:len(traj)]))
    assert ate < 0.5, ate
    return start


@pytest.fixture(scope="module")
def runs():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield _run()
    finally:
        torch.set_num_threads(before)


def _run():
    wj = jsim.world_from_trajectory(_gentle_positions(T), n_points=2500, seed=1)
    wt = tsim.world_from_trajectory(_gentle_positions(T), n_points=2500, seed=1)
    jt = JTracker(JConfig(orb=JOrb(n_features=512), **KW))
    tt = MonoTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                     device="cpu")
    log_j, log_t, snaps, loss = [], [], {}, None
    for k in range(T):
        # the reference's state before each frame until it first loses
        # track (carried with its background local BA drained)
        snap = copy.deepcopy(jt) if loss is None else None
        if k == CARRY_AT:
            carry = copy.deepcopy(jt)
            snaps[k] = (h.jax_tracker_state(carry), carry)
        img = jsim.render_image(wj, k, jnp.asarray(CAM, jnp.float32), (H, W))
        rj = jt.process_image(jnp.asarray(img), float(wj.timestamps[k]))
        log_j.append(_row(jt, rj))
        if loss is None and rj.state == "lost":
            loss = (k, h.jax_tracker_state(snap), snap)
        img = tsim.render_image(wt, k, CAM, (H, W))
        rt = tt.process_image(img, float(wt.timestamps[k]))
        log_t.append(_row(tt, rt))
    return dict(jt=jt, tt=tt, wj=wj, wt=wt, log_j=log_j, log_t=log_t,
                snaps=snaps, loss=loss)


@pinned
def test_both_pass_the_image_e2e_gates(runs):
    gt = tsim.gt_positions(runs["wt"])
    sj = _gates(runs["jt"], [r[0] for r in runs["log_j"]], gt)
    st = _gates(runs["tt"], [r[0] for r in runs["log_t"]], gt)
    assert sj == st


@pinned
def test_init_and_first_tracked_frames_match(runs):
    lj, lt = runs["log_j"], runs["log_t"]
    start = [r[0] for r in lj].index("init-done")
    assert lj[: start + 6] == lt[: start + 6]


@pinned
def test_carried_state_steps_match(runs):
    """From the reference's state at frame 22 both step frames 22 and 23
    alike (state, inliers, keyframes, map points; pose atol 1e-4, 1e-3
    after the keyframe's local BA). Frame
    22 inserts a keyframe; its mapping step, replayed in both packages from
    the reference's own inputs, is exact in every integer table and within
    1e-5 in positions. (Run on, the last-bit pose difference the tracking
    step leaves moves one triangulation across its gate, which shifts the
    ids of the later new points; counts stay equal.)"""
    state, jt = runs["snaps"][CARRY_AT]
    tt = MonoTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                     device="cpu")
    convert.tracker_state_from_numpy(tt, state)
    seen = {}
    insert = jt._insert_keyframe

    def capture(feats, ts, obs):
        seen["inputs"] = (jt.map, jt.cur_pose, feats, ts, obs)
        return insert(feats, ts, obs)

    jt._insert_keyframe = capture
    for k in range(CARRY_AT, CARRY_AT + 2):
        img = tsim.render_image(runs["wt"], k, CAM, (H, W))
        rj = jt.process_image(jnp.asarray(img),
                              float(runs["wj"].timestamps[k]))
        rt = tt.process_image(img, float(runs["wt"].timestamps[k]))
        assert _row(jt, rj) == _row(tt, rt), k
        # frame 23 tracks against the window the keyframe's local BA just
        # refined, which agrees only to ~1e-4 m (ROADMAP C2)
        np.testing.assert_allclose(np.asarray(jt.cur_pose.t),
                                   tt.cur_pose.t.numpy(),
                                   atol=1e-4 if k == CARRY_AT else 1e-3)
    mj, pose, feats, ts, obs = seen["inputs"]
    n = int(mj.n_kf)
    prev = np.concatenate([[n - 1, n - 2, n - 3], np.asarray(
        jmapping.top_covisible(mj, obs, jnp.int32(n - 3), k=3))]).astype(
            np.int32)
    cam = np.asarray(CAM, np.float32)
    aj = jmapping.mapping_step(
        mj, pose, ts, feats.uv, feats.desc, feats.octave, feats.valid, obs,
        jnp.asarray(prev), jnp.asarray(cam), img_h=H, img_w=W, n_prev=6)
    ft = convert.features_from_numpy(h.jax_features_to_numpy(feats), "cpu")
    at = tmapping.mapping_step(
        convert.map_state_from_numpy(h.jax_map_to_numpy(mj), "cpu"),
        h.tse3(np.asarray(pose.R), np.asarray(pose.t)), ts, ft.uv, ft.desc,
        ft.octave, ft.valid, torch.from_numpy(np.array(obs)),
        torch.from_numpy(prev), torch.from_numpy(cam), img_h=H, img_w=W,
        n_prev=6)
    np.testing.assert_array_equal(np.asarray(aj.stats), at.stats.numpy())
    h.assert_map_close(h.jax_map_to_numpy(aj.map),
                       convert.map_state_to_numpy(at.map), atol=1e-5)


@pinned
def test_carried_state_through_the_loss(runs):
    """From the reference's state on the frame where it first loses track,
    the port loses track on that frame and fails to relocalize on the next
    two exactly as the reference does: the tracking-loss decision is the
    reference's from the same state (the free-running sessions part before
    it, through drift). Carrying the state drains the background local BA
    in flight, which from an earlier frame changes the reference's own
    course (from frame 41 it no longer loses track), so the state is the
    one on the loss frame itself."""
    assert runs["loss"] is not None, "the reference never loses track"
    k0, state, jt = runs["loss"]
    tt = MonoTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                     device="cpu")
    convert.tracker_state_from_numpy(tt, state)
    rows = []
    for k in range(k0, k0 + 3):
        img = tsim.render_image(runs["wt"], k, CAM, (H, W))
        rj = jt.process_image(jnp.asarray(img),
                              float(runs["wj"].timestamps[k]))
        rt = tt.process_image(img, float(runs["wt"].timestamps[k]))
        assert _row(jt, rj) == _row(tt, rt), k
        rows.append(rj.state)
    assert rows == ["lost", "reloc-fail", "reloc-fail"]
