"""PyTorch port parity: the distributed visual-inertial BA.

Counterparts of ``tests/test_dist_vi_ba.py``'s three cases. The
reference's own builder (``test_dist_vi_ba._problem``: a simulated body
trajectory, its host preintegrations, 120 or 101 points seen from every
keyframe, perturbed poses and velocities) makes the inputs; they go to
the JAX package's ``distributed_visual_inertial_ba`` on its 8 virtual CPU
devices and, as the same numpy arrays, to the port's on 8 CPU shards, and
to the port's single-device ``visual_inertial_ba`` at 1, 3 and 8 shards.

Tolerances (those of ``tests/test_torch_vi_ba.py``): poses, velocities
and biases within 1e-4, points within 1e-3 m, candidate costs within 1e-3
relative or 1e-5 of the largest absolute (the sums run in another order,
and the inertial terms weigh residuals by informations up to ~1e8, so a
converged cost is float32 rounding at ~1e-5 of the first).
The reference test's gates hold on the port's result too.
"""

import functools

import numpy as np
import pytest
import torch

import test_dist_vi_ba as ref
import test_torch_helpers as h
from orb_slam_fusion_tpu.parallel import (
    distributed_visual_inertial_ba as j_dvi, make_slam_mesh as j_mesh)
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.imu.preintegration import ImuCalib
from orb_slam_fusion_tpu_torch.map import convert
from orb_slam_fusion_tpu_torch.parallel import (
    distributed_visual_inertial_ba, make_slam_mesh)
from orb_slam_fusion_tpu_torch.solver import vi_ba as tvi
from test_torch_parallel import assert_costs, port_problem

torch.set_num_threads(1)
CPU = torch.device("cpu")
STATE_ATOL = 1e-4
POINT_ATOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(state0, prob, ifac, calib):
    """The port's (state, problem, factors, calib) from the reference's."""
    st = tvi.VIState(tlie.SE3(_t(state0.poses.R), _t(state0.poses.t)),
                     _t(state0.vel), _t(state0.bg).float(),
                     _t(state0.ba).float())
    pre = convert.preintegrated_from_numpy(
        h.jax_preintegrated_to_numpy(ifac.pre), CPU)
    tf = tvi.InertialFactorBatch(i=_t(ifac.i), j=_t(ifac.j), pre=pre,
                                 info=_t(ifac.info), valid=_t(ifac.valid))
    tc = ImuCalib(**{n: _t(getattr(calib, n)).float()
                     for n in ImuCalib._fields})
    return st, port_problem(prob), tf, tc


def _assert_state(j, t):
    """(state, points, costs) of the reference against the port's."""
    js, ts = j[0], t[0]
    for a, b, name in ((js.poses.R, ts.poses.R, "R"),
                       (js.poses.t, ts.poses.t, "t"), (js.vel, ts.vel, "vel"),
                       (js.bg, ts.bg, "bg"), (js.ba, ts.ba, "ba")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=STATE_ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]),
                               atol=POINT_ATOL, rtol=0)
    assert_costs(t[2], j[2], floor=1e-5)


@functools.lru_cache(maxsize=None)
def _reference(n_pts, seed, iters):
    state0, prob, ifac, calib, fixed, poses_true, vel_true = ref._problem(
        seed=seed, n_pts=n_pts)
    j = j_dvi(state0, prob, ifac, calib, j_mesh(8), fixed_pose=fixed,
              iters=iters)
    return (state0, prob, ifac, calib, fixed, poses_true, vel_true), j


@functools.lru_cache(maxsize=None)
def _single_device(seed, iters):
    (state0, prob, ifac, calib, fixed, _, _), _ = _reference(120, seed, iters)
    ts, tp, tf, tc = _port(state0, prob, ifac, calib)
    return tvi.visual_inertial_ba(ts, tp, tf, tc, fixed_pose=_t(fixed),
                                  iters=iters)


def _both(n_pts=120, seed=1, iters=10, D=8):
    (state0, prob, ifac, calib, fixed, poses_true, vel_true), j = \
        _reference(n_pts, seed, iters)
    ts, tp, tf, tc = _port(state0, prob, ifac, calib)
    t = distributed_visual_inertial_ba(
        ts, tp, tf, tc, make_slam_mesh(devices=[CPU] * D),
        fixed_pose=_t(fixed), iters=iters)
    return j, t, (ts, tp, tf, tc, _t(fixed)), poses_true, vel_true


def test_descends_and_recovers_state():
    """The reference's first case: its result and its gates (cost down
    4x, poses within 5e-3 of the truth, velocities 0.05, gyro bias)."""
    j, t, _, poses_true, vel_true = _both()
    _assert_state(j, t)
    costs = t[2].numpy()
    assert costs[-1] < costs[0] * 0.25, costs
    rel = tlie.se3_compose(t[0].poses, tlie.se3_inverse(
        tlie.SE3(_t(poses_true.R), _t(poses_true.t))))
    assert tlie.se3_log(rel).abs().max().item() < 5e-3
    assert (t[0].vel - _t(vel_true)).abs().max().item() < 0.05
    assert t[0].bg.abs().max().item() < 5e-3


@pytest.mark.parametrize("D", [1, 3, 8])
def test_matches_single_device(D):
    """The reference's second case (seed 2, 8 iterations) at 1, 3 and 8
    shards: the reference's mesh result, and the port's single-device
    ``visual_inertial_ba`` (the reference test's bounds are 2e-3 m and
    5e-3 m/s; these are 1e-4)."""
    j, t, _, _, _ = _both(seed=2, iters=8, D=D)
    _assert_state(j, t)
    s = _single_device(2, 8)
    _assert_state(tuple(
        (tvi.VIState(tlie.SE3(x.poses.R.numpy(), x.poses.t.numpy()),
                     x.vel.numpy(), x.bg.numpy(), x.ba.numpy())
         if i == 0 else x.numpy()) for i, x in enumerate(s)), t)


def test_nondivisible_landmark_count():
    """101 points pad to 104 over 8 shards: the pads stay inert (the
    reference's result, finite descending costs, 101 points back)."""
    j, t, _, _, _ = _both(n_pts=101, iters=6)
    _assert_state(j, t)
    costs = t[2].numpy()
    assert np.isfinite(costs).all()
    assert costs[-1] < costs[0]
    assert t[1].shape == (101, 3)
