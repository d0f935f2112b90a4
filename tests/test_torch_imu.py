"""PyTorch port parity: IMU preintegration and the inertial residuals.

Seeded IMU windows (numpy) go through the JAX package's
``imu/preintegration.py`` and ``imu/factors.py`` and the port's
counterparts on the CPU:

* ``preintegrate_host`` (the sessions' float64 integrator): every field
  bit-exact;
* ``preintegrate`` (float32, padded windows) and the backward variant:
  1e-5 relative to each field's largest entry, except the gyro-bias
  Jacobians JRg, JVg, JPg, held to 1e-4: they accumulate the float32
  right Jacobian of 1e-3 rad steps, whose (1 - cos th) / th^2 moves by
  ~6% with one ulp of th^2, and XLA's fused scan rounds th^2 differently;
* ``bias_corrected_delta`` (both directions), ``inertial_residual`` and
  its backward variant: 1e-5 relative to the largest entry (2e-6 absolute
  floor: the residuals are differences of order-one quantities);
* ``information_from_cov``: 1e-4 relative (a float32 9x9 inverse, then
  the spectrum cap); ``bias_walk_residual`` exact;
* ``make_calib`` bit-exact, and the port's ``sim.make_vio_sequence``
  bit-exact against the reference's (trajectory, IMU samples, points,
  descriptors), on the stereo-inertial and the staged sequences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.imu import factors as jf
from orb_slam_fusion_tpu.imu import preintegration as jp
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.imu import factors as tf
from orb_slam_fusion_tpu_torch.imu import preintegration as tp
from orb_slam_fusion_tpu_torch.map import convert

import test_torch_helpers as h

torch.set_num_threads(1)
JR_FIELDS = ("JRg", "JVg", "JPg")


def _window(seed, n=12, pad=3):
    """A 200 Hz window of specific force and rates with ``pad`` dt = 0
    rows at the end, and a bias."""
    rng = np.random.RandomState(seed)
    acc = (rng.randn(n + pad, 3) * 0.5 + [0.0, 0.0, 9.81]).astype(np.float32)
    gyro = (rng.randn(n + pad, 3) * 0.2).astype(np.float32)
    dts = np.full(n + pad, 0.005)
    dts[n:] = 0.0
    dts[:n] *= rng.uniform(0.9, 1.1, n)
    bg = (rng.randn(3) * 0.01).astype(np.float32)
    ba = (rng.randn(3) * 0.1).astype(np.float32)
    return acc, gyro, dts, bg, ba


def _biases(bg, ba):
    return (jp.ImuBias(jnp.asarray(bg), jnp.asarray(ba)),
            tp.ImuBias(torch.from_numpy(bg), torch.from_numpy(ba)))


def _calibs():
    return jp.make_calib(), tp.make_calib(device="cpu")


def _close(want, got, rtol, floor=0.0, err=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    tol = max(rtol * np.abs(want).max(), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=err)


def test_make_calib_bit_exact():
    jc, tc = _calibs()
    for f in tp.ImuCalib._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      getattr(tc, f).numpy(), err_msg=f)
    R = h.rot([0.1, -0.2, 0.05])
    jc2 = jp.make_calib(Tbc_R=R, Tbc_t=[0.01, 0.02, -0.03], freq=100.0)
    tc2 = tp.make_calib(Tbc_R=R, Tbc_t=[0.01, 0.02, -0.03], freq=100.0,
                        device="cpu")
    for f in tp.ImuCalib._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc2, f)),
                                      getattr(tc2, f).numpy(), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preintegrate_host_bit_exact(seed):
    acc, gyro, dts, bg, ba = _window(seed)
    if seed == 2:
        bg[:] = 0.0
        ba[:] = 0.0
    jb, tb = _biases(bg, ba)
    jc, tc = _calibs()
    pj = jp.preintegrate_host(acc, gyro, dts, jb, jc)
    pt = tp.preintegrate_host(acc, gyro, dts, tb, tc)
    for f in tp.Preintegrated._fields:
        if f == "bias0":
            continue
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_pre_close(pj, pt, rtol=1e-5, jr_rtol=1e-4):
    for f in tp.Preintegrated._fields:
        if f == "bias0":
            continue
        _close(getattr(pj, f), getattr(pt, f).numpy(),
               jr_rtol if f in JR_FIELDS else rtol, err=f)


@pytest.mark.parametrize("seed", [3, 4])
def test_preintegrate_device_forward_and_backward(seed):
    acc, gyro, dts, bg, ba = _window(seed)
    jb, tb = _biases(bg, ba)
    jc, tc = _calibs()
    d32 = dts.astype(np.float32)
    args_j = (jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(d32))
    args_t = (torch.from_numpy(acc), torch.from_numpy(gyro),
              torch.from_numpy(d32))
    _assert_pre_close(jp.preintegrate(*args_j, jb, jc),
                      tp.preintegrate(*args_t, tb, tc))
    _assert_pre_close(jp.preintegrate_backward(*args_j, jb, jc),
                      tp.preintegrate_backward(*args_t, tb, tc))


def _host_pre(seed):
    acc, gyro, dts, bg, ba = _window(seed)
    jb, tb = _biases(bg, ba)
    jc, tc = _calibs()
    return (jp.preintegrate_host(acc, gyro, dts, jb, jc),
            tp.preintegrate_host(acc, gyro, dts, tb, tc))


def _state(rng, pre_np):
    """Two body states roughly consistent with a preintegrated delta, then
    perturbed, and a moved bias."""
    Ri = h.rot(rng.randn(3) * 0.5)
    pi = rng.randn(3).astype(np.float32)
    vi = rng.randn(3).astype(np.float32)
    dt = float(pre_np["dT"])
    g = np.array([0.0, 0.0, -9.81], np.float32)
    Rj = (Ri @ pre_np["dR"] @ h.rot(rng.randn(3) * 0.01)).astype(np.float32)
    vj = (vi + g * dt + Ri @ pre_np["dV"] + rng.randn(3) * 0.01).astype(
        np.float32)
    pj = (pi + vi * dt + 0.5 * g * dt * dt + Ri @ pre_np["dP"]
          + rng.randn(3) * 0.01).astype(np.float32)
    bg = (rng.randn(3) * 0.02).astype(np.float32)
    ba = (rng.randn(3) * 0.2).astype(np.float32)
    return [Ri, pi, vi, Rj, pj, vj], (bg, ba)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_residuals_and_bias_correction(seed):
    rng = np.random.RandomState(seed)
    pj, pt = _host_pre(seed)
    pre_np = h.jax_preintegrated_to_numpy(pj)
    xs, (bg, ba) = _state(rng, pre_np)
    jb, tb = _biases(bg, ba)
    g_j = jp.GRAVITY_VEC
    g_t = tp.gravity_vec("cpu")
    for a, b in zip(jp.bias_corrected_delta(pj, jb),
                    tp.bias_corrected_delta(pt, tb)):
        _close(a, b.numpy(), 1e-5)
    rj = jf.inertial_residual(pj, *(jnp.asarray(x) for x in xs), jb, g_j)
    rt = tf.inertial_residual(pt, *(torch.from_numpy(x) for x in xs), tb,
                              g_t)
    _close(rj, rt.numpy(), 1e-5, 2e-6)

    acc, gyro, dts, bg0, ba0 = _window(seed)
    jb0, tb0 = _biases(bg0, ba0)
    jc, tc = _calibs()
    d32 = dts.astype(np.float32)
    bj = jp.preintegrate_backward(jnp.asarray(acc), jnp.asarray(gyro),
                                  jnp.asarray(d32), jb0, jc)
    bt = tp.preintegrate_backward(torch.from_numpy(acc),
                                  torch.from_numpy(gyro),
                                  torch.from_numpy(d32), tb0, tc)
    for a, b in zip(jp.bias_corrected_delta_backward(bj, jb),
                    tp.bias_corrected_delta_backward(bt, tb)):
        _close(a, b.numpy(), 1e-4)
    rj = jf.inertial_residual_backward(bj, *(jnp.asarray(x) for x in xs),
                                       jb, g_j)
    rt = tf.inertial_residual_backward(
        bt, *(torch.from_numpy(x) for x in xs), tb, g_t)
    _close(rj, rt.numpy(), 1e-4, 2e-6)


def test_residual_batched_matches_single():
    """The port's residuals broadcast over a batch of factors (the VI-BA
    evaluates all of them at once); each row equals its single call."""
    rows, singles = [], []
    pres = []
    for seed in (8, 9, 10):
        rng = np.random.RandomState(seed)
        pj, pt = _host_pre(seed)
        xs, (bg, ba) = _state(rng, h.jax_preintegrated_to_numpy(pj))
        tb = tp.ImuBias(torch.from_numpy(bg), torch.from_numpy(ba))
        xt = [torch.from_numpy(x) for x in xs]
        singles.append(tf.inertial_residual(pt, *xt, tb, tp.gravity_vec(
            "cpu")))
        rows.append((xt, tb))
        pres.append(pt)
    batch = tp.stack_preintegrated(pres)
    xb = [torch.stack([r[0][i] for r in rows]) for i in range(6)]
    bb = tp.ImuBias(torch.stack([r[1].gyro for r in rows]),
                    torch.stack([r[1].acc for r in rows]))
    got = tf.inertial_residual(batch, *xb, bb, tp.gravity_vec("cpu"))
    np.testing.assert_allclose(got.numpy(), torch.stack(singles).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [11, 12])
def test_information_from_cov_and_bias_walk(seed):
    pj, pt = _host_pre(seed)
    _close(jf.information_from_cov(pj), tf.information_from_cov(pt).numpy(),
           1e-4)
    # a batch, as the VI-BA builds it
    pj2, pt2 = _host_pre(seed + 10)
    bt = tp.stack_preintegrated([pt, pt2])
    got = tf.information_from_cov(bt).numpy()
    _close(jf.information_from_cov(pj2), got[1], 1e-4)
    rng = np.random.RandomState(seed)
    b = [rng.randn(3).astype(np.float32) for _ in range(4)]
    wj = jf.bias_walk_residual(jp.ImuBias(*map(jnp.asarray, b[:2])),
                               jp.ImuBias(*map(jnp.asarray, b[2:])))
    wt = tf.bias_walk_residual(tp.ImuBias(*map(torch.from_numpy, b[:2])),
                               tp.ImuBias(*map(torch.from_numpy, b[2:])))
    for a, c in zip(wj, wt):
        np.testing.assert_array_equal(np.asarray(a), c.numpy())


def test_preintegrated_round_trip():
    pj, pt = _host_pre(13)
    back = convert.preintegrated_from_numpy(
        h.jax_preintegrated_to_numpy(pj), "cpu")
    for f in tp.Preintegrated._fields:
        if f != "bias0":
            assert torch.equal(getattr(back, f), getattr(pt, f)), f


@pytest.mark.parametrize("kw", [
    dict(n_frames=80, seed=4, gyro_noise=1.7e-4, acc_noise=2e-3,
         gyro_bias=0.002, acc_bias=0.02),
    dict(n_frames=60, fps=10.0, seed=4, gyro_noise=1.7e-4, acc_noise=2e-3,
         gyro_bias=0.005, acc_bias=0.04)],
    ids=["stereo_vio", "staged"])
def test_make_vio_sequence_bit_exact(kw):
    a = jsim.make_vio_sequence(**kw)
    b = tsim.make_vio_sequence(**kw)
    np.testing.assert_array_equal(np.asarray(a.world.poses.R), b.world.poses.R)
    np.testing.assert_array_equal(np.asarray(a.world.poses.t), b.world.poses.t)
    for f in ("points", "descriptors", "timestamps", "ref_dist"):
        x, y = getattr(a.world, f), getattr(b.world, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(np.asarray(x), y, err_msg=f)
    assert len(a.frame_imu) == len(b.frame_imu)
    for fa, fb in zip(a.frame_imu, b.frame_imu):
        for x, y in zip(fa, fb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for f in ("vel", "gravity", "gyro_bias_true", "acc_bias_true"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
