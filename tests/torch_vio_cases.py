"""The inertial sessions' parity cases, shared by the ``test_torch_vio_*``
files (no tests here).

``checkpoints`` runs a JAX-package inertial tracker over a sequence and
keeps a copy of its state just before four kinds of frame: a keyframe
before IMU init, the IMU-init keyframe (stage 0 -> 1), a plain tracked
frame after init, and the VIBA1 keyframe (stage 1 -> 2). ``step_both``
loads such a state into the port's tracker
(``convert.tracker_state_from_numpy``) and steps both one frame.
"""

import copy

import numpy as np
import torch

import chip_smoke
import test_torch_helpers as h
from orb_slam_fusion_tpu_torch.map import convert

LABELS = ("pre_init_keyframe", "imu_init_keyframe", "plain_after_init",
          "viba1_keyframe")


imu_of = chip_smoke._imu_of


def checkpoints(tracker, step, n_frames):
    """{label: (frame, reference tracker just before it)} for LABELS."""
    found = {}
    init_frame = None
    for k in range(n_frames):
        snap = copy.deepcopy(tracker)
        stage0, n_kf0 = tracker._imu_stage, int(tracker.map.n_kf)
        rec = step(tracker, k)
        stage, new_kf = tracker._imu_stage, int(tracker.map.n_kf) > n_kf0
        label = None
        if stage0 == 0 and stage == 1:
            label, init_frame = "imu_init_keyframe", k
        elif stage0 == 1 and stage == 2:
            label = "viba1_keyframe"
        elif stage == 0 and new_kf and k >= 8 and rec.state == "ok":
            label = "pre_init_keyframe"
        elif (stage >= 1 and not new_kf and rec.state == "ok"
              and init_frame is not None and k >= init_frame + 3):
            label = "plain_after_init"
        if label and label not in found:
            found[label] = (k, snap)
        if len(found) == len(LABELS):
            break
    return found


def _row(tr, rec):
    return (rec.state, int(rec.tracked), int(tr.map.n_kf), int(tr.map.n_mp),
            int(tr._imu_stage), bool(tr.imu_initialized),
            tr.frames_since_kf, tr.last_kf_id)


def step_both(snap, port, k, step_ref, step_port, atol=1e-4):
    """Carry ``snap``'s state into ``port``, step both on frame k and
    compare: the frame record, counts, stage and the integer map tables
    exactly; pose, velocity and bias within ``atol``."""
    convert.tracker_state_from_numpy(port, h.jax_tracker_state(snap))
    rj = step_ref(snap, k)
    rt = step_port(port, k)
    assert _row(snap, rj) == _row(port, rt), (k, _row(snap, rj),
                                               _row(port, rt))
    for a, b in ((snap.cur_pose.R, port.cur_pose.R),
                 (snap.cur_pose.t, port.cur_pose.t),
                 (snap.cur_vel, port.cur_vel),
                 (snap.bias.gyro, port.bias.gyro),
                 (snap.bias.acc, port.bias.acc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                                   rtol=0)
    a = h.jax_map_to_numpy(snap.map)
    b = convert.map_state_to_numpy(port.map)
    for f in ("kf_valid", "kf_obs_mp", "mp_valid", "mp_visible", "mp_found",
              "n_kf", "n_mp"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{k} {f}")
    np.testing.assert_allclose(b["kf_pose"][1], a["kf_pose"][1], atol=atol,
                               rtol=0)
    if hasattr(snap, "kf_uright"):
        np.testing.assert_array_equal(
            np.asarray(snap.kf_uright).view(np.int32),
            port.kf_uright.numpy().view(np.int32))
    assert len(snap.kf_pre) == len(port.kf_pre)
    assert [p is None for p in snap.kf_pre] == [p is None
                                                for p in port.kf_pre]
    for kv_a, kv_b in zip(snap.kf_vel, port.kf_vel):
        np.testing.assert_allclose(kv_b, np.asarray(kv_a), atol=atol, rtol=0)
    assert snap.kf_time == port.kf_time


def with_threads(n, fn):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)
