"""PyTorch port parity: the per-frame pose-inertial solvers.

Seeded frames of the port's ``make_vio_sequence`` (bit-exact with the
reference's): ~200 points seen by the current frame with 0.5 px noise and
~10% gross outliers, the host preintegration from the previous frame, the
current pose and velocity perturbed. Both packages' ``pose_inertial_
optimization`` (previous state fixed) and ``pose_inertial_marginalized``
(previous state under a 15-dim prior, marginalized after the solve; two
frames chained so the second carries the first's marginal) run on the
same inputs: pose and velocity (and the shared bias) within 1e-4, the
chi-square inlier masks and counts exact, the marginalized prior's
information within 1e-3 of its largest entry. ``inflate_bias_walk`` and
``make_initial_prior`` are held to the reference at 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu.imu import preintegration as jp
from orb_slam_fusion_tpu.imu.factors import information_from_cov as j_info
from orb_slam_fusion_tpu.solver import pose_inertial as jpi
from orb_slam_fusion_tpu.solver import pose_inertial_prior as jpp
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.imu import preintegration as tp
from orb_slam_fusion_tpu_torch.imu.factors import information_from_cov as t_info
from orb_slam_fusion_tpu_torch.solver import pose_inertial as tpi
from orb_slam_fusion_tpu_torch.solver import pose_inertial_prior as tpp

import test_torch_helpers as h

torch.set_num_threads(1)
CAM = (400.0, 400.0, 376.0, 240.0)


def _frames(seed, n_pts=200):
    """Frames 2 and 3 (and 4) of a VIO sequence: GT states, the frame-to-
    frame preintegrations, observations of the later frames."""
    rng = np.random.RandomState(seed)
    seq = tsim.make_vio_sequence(n_frames=6, seed=seed, gyro_noise=1.7e-4,
                                 acc_noise=2e-3, gyro_bias=0.002,
                                 acc_bias=0.02)
    R, t = seq.world.poses.R, seq.world.poses.t
    c = -R[3].T @ t[3]
    pts = (c + R[3][2] * 7.0 + rng.uniform(-3, 3, (n_pts, 3))).astype(
        np.float32)
    out = dict(R=R, t=t, vel=seq.vel.astype(np.float32), pts=pts, obs={},
               raw={})
    for f in (3, 4):
        pc = pts @ R[f].T + t[f]
        uv = np.stack([CAM[0] * pc[:, 0] / pc[:, 2] + CAM[2],
                       CAM[1] * pc[:, 1] / pc[:, 2] + CAM[3]], 1)
        uv += rng.randn(*uv.shape) * 0.5
        bad = rng.rand(n_pts) < 0.1
        uv[bad] += rng.uniform(-25, 25, (bad.sum(), 2))
        valid = (pc[:, 2] > 0.5) & (rng.rand(n_pts) > 0.05)
        inv_s2 = np.where(rng.rand(n_pts) < 0.2, 1 / 1.44, 1.0)
        out["obs"][f] = (uv.astype(np.float32), inv_s2.astype(np.float32),
                         valid)
        acc, gyr, _ = seq.frame_imu[f - 1]
        out["raw"][f] = (acc, gyr, np.full(len(acc), 0.005))
    out["noise"] = [(h.rot(rng.randn(3) * 0.01), rng.randn(3) * 0.03,
                     rng.randn(3) * 0.05) for _ in range(2)]
    return out


def _pre(d, f):
    z = np.zeros(3, np.float32)
    jb = jp.ImuBias(jnp.asarray(z), jnp.asarray(z))
    tb = tp.ImuBias(torch.from_numpy(z), torch.from_numpy(z))
    pj = jp.preintegrate_host(*d["raw"][f], jb, jp.make_calib())
    pt = tp.preintegrate_host(*d["raw"][f], tb, tp.make_calib(device="cpu"))
    return pj, pt


def _init(d, f, k):
    dR, dt, dv = d["noise"][k]
    R0 = (d["R"][f] @ dR).astype(np.float32)
    t0 = (d["t"][f] + dt).astype(np.float32)
    v0 = (d["vel"][f] + dv).astype(np.float32)
    return R0, t0, v0


def _obs_args(d, f):
    uv, inv_s2, valid = d["obs"][f]
    return ((jnp.asarray(d["pts"]), jnp.asarray(uv), jnp.asarray(inv_s2),
             jnp.asarray(valid), jnp.asarray(CAM)),
            (torch.from_numpy(d["pts"]), torch.from_numpy(uv),
             torch.from_numpy(inv_s2), torch.from_numpy(valid),
             torch.tensor(CAM)))


def _assert_pose(pj, vj, pt, vt, atol=1e-4):
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_inertial_optimization(seed):
    d = _frames(seed)
    pj, pt = _pre(d, 3)
    R0, t0, v0 = _init(d, 3, 0)
    oj, ot = _obs_args(d, 3)
    z = np.zeros(3, np.float32)
    rj = jpi.pose_inertial_optimization(
        h.jse3(R0, t0), jnp.asarray(v0), h.jse3(d["R"][2], d["t"][2]),
        jnp.asarray(d["vel"][2]), jp.ImuBias(jnp.asarray(z), jnp.asarray(z)),
        pj, j_info(pj), jp.make_calib(), *oj)
    rt = tpi.pose_inertial_optimization(
        h.tse3(R0, t0), torch.from_numpy(v0), h.tse3(d["R"][2], d["t"][2]),
        torch.from_numpy(d["vel"][2]),
        tp.ImuBias(torch.from_numpy(z), torch.from_numpy(z)), pt, t_info(pt),
        tp.make_calib(device="cpu"), *ot)
    _assert_pose(rj[0], rj[1], rt[0], rt[1])
    np.testing.assert_array_equal(rt[2].numpy(), np.asarray(rj[2]))
    assert int(rt[3]) == int(rj[3])
    assert 0 < int(rt[3]) < int(np.asarray(d["obs"][3][2]).sum())


def _prior_pair(d, f):
    z = np.zeros(3, np.float32)
    jpr = jpp.make_initial_prior(h.jse3(d["R"][f], d["t"][f]),
                                 jnp.asarray(d["vel"][f]),
                                 jp.ImuBias(jnp.asarray(z), jnp.asarray(z)))
    tpr = tpp.make_initial_prior(h.tse3(d["R"][f], d["t"][f]),
                                 torch.from_numpy(d["vel"][f]),
                                 tp.ImuBias(torch.from_numpy(z),
                                            torch.from_numpy(z)))
    np.testing.assert_array_equal(tpr.H.numpy(), np.asarray(jpr.H))
    return jpr, tpr


def _assert_prior(a, b, rtol=1e-3):
    Ha, Hb = np.asarray(a.H, np.float64), b.H.numpy().astype(np.float64)
    assert np.abs(Ha - Hb).max() <= rtol * np.abs(Ha).max()
    _assert_pose(a.pose, a.vel, b.pose, b.vel)
    np.testing.assert_allclose(b.bg.numpy(), np.asarray(a.bg), atol=1e-4)
    np.testing.assert_allclose(b.ba.numpy(), np.asarray(a.ba), atol=1e-4)


@pytest.mark.parametrize("seed", [2, 3])
def test_pose_inertial_marginalized_chain(seed):
    d = _frames(seed)
    jpr, tpr = _prior_pair(d, 2)
    for k, f in enumerate((3, 4)):
        pj, pt = _pre(d, f)
        R0, t0, v0 = _init(d, f, k)
        oj, ot = _obs_args(d, f)
        rj = jpp.pose_inertial_marginalized(
            jpr, h.jse3(R0, t0), jnp.asarray(v0), pj, j_info(pj),
            jp.make_calib(), *oj)
        rt = tpp.pose_inertial_marginalized(
            tpr, h.tse3(R0, t0), torch.from_numpy(v0), pt, t_info(pt),
            tp.make_calib(device="cpu"), *ot)
        _assert_pose(rj[0], rj[1], rt[0], rt[1])
        np.testing.assert_allclose(rt[2].gyro.numpy(), np.asarray(rj[2].gyro),
                                   atol=1e-4)
        np.testing.assert_allclose(rt[2].acc.numpy(), np.asarray(rj[2].acc),
                                   atol=1e-4)
        np.testing.assert_array_equal(rt[4].numpy(), np.asarray(rj[4]))
        assert int(rt[5]) == int(rj[5])
        _assert_prior(rj[3], rt[3])
        # the next frame carries each package's own marginal
        jpr, tpr = rj[3], rt[3]


@pytest.mark.parametrize("dT", [0.05, 0.25])
def test_inflate_bias_walk(dT):
    rng = np.random.RandomState(int(dT * 100))
    A = rng.randn(15, 15)
    H = (A @ A.T + np.diag(np.r_[[1e4] * 6, [1e2] * 3, [1e4] * 3,
                                 [1e2] * 3])).astype(np.float32)
    a = jpp.inflate_bias_walk(jnp.asarray(H), jp.make_calib(),
                              jnp.asarray(dT, jnp.float32))
    b = tpp.inflate_bias_walk(torch.from_numpy(H),
                              tp.make_calib(device="cpu"),
                              torch.tensor(dT, dtype=torch.float32))
    a = np.asarray(a, np.float64)
    assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()
