"""On-manifold IMU preintegration (Forster et al.).

Counterpart of ``orb_slam_fusion_tpu/imu/preintegration.py``. The sessions
integrate on the host (``preintegrate_host``): float64 numpy, the
reference's code line for line, returning float32 tensors on the device
the caller names. ``preintegrate`` (float32, a window padded with dt = 0
rows) and the backward variant are the device versions; only tests and
the bidirectional factors reach them, so they are plain loops over the
window rather than a scan.

All quantities of a ``Preintegrated`` are expressed at its linearization
bias ``bias0``. Gravity magnitude 9.81.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import lie, resolve_device

GRAVITY = 9.81


def gravity_vec(device=None, dtype=torch.float32) -> torch.Tensor:
    """(0, 0, -9.81) on ``device``."""
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=dtype,
                        device=resolve_device(device))


class ImuCalib(NamedTuple):
    """Sensor calibration (reference IMU::Calib)."""

    Tbc_R: torch.Tensor       # (3,3) camera-to-body rotation
    Tbc_t: torch.Tensor       # (3,)  camera-to-body translation
    noise_gyro: torch.Tensor  # () rad/s/sqrt(Hz) * sqrt(freq)
    noise_acc: torch.Tensor   # () m/s^2/sqrt(Hz) * sqrt(freq)
    walk_gyro: torch.Tensor   # () bias random walk
    walk_acc: torch.Tensor    # ()


def make_calib(Tbc_R=None, Tbc_t=None, noise_gyro=1.7e-4, noise_acc=2e-3,
               walk_gyro=1.9e-5, walk_acc=3e-3, freq=200.0,
               device=None) -> ImuCalib:
    """Calib with discrete-time noise densities (sigma * sqrt(freq)), all
    float32 as the reference rounds them."""
    dev = resolve_device(device)
    f32 = np.float32
    sf = np.sqrt(f32(freq))

    def t(x):
        return torch.tensor(np.asarray(x, f32), device=dev)

    return ImuCalib(
        Tbc_R=t(np.eye(3) if Tbc_R is None else Tbc_R),
        Tbc_t=t(np.zeros(3) if Tbc_t is None else Tbc_t),
        noise_gyro=t(f32(noise_gyro) * sf), noise_acc=t(f32(noise_acc) * sf),
        walk_gyro=t(walk_gyro), walk_acc=t(walk_acc))


class ImuBias(NamedTuple):
    gyro: torch.Tensor  # (..., 3)
    acc: torch.Tensor   # (..., 3)


def zero_bias(device=None, dtype=torch.float32) -> ImuBias:
    dev = resolve_device(device)
    return ImuBias(torch.zeros(3, dtype=dtype, device=dev),
                   torch.zeros(3, dtype=dtype, device=dev))


class Preintegrated(NamedTuple):
    """Preintegrated deltas between two frames or keyframes (fields may
    carry a leading batch axis: a batch of factors)."""

    dT: torch.Tensor        # () total time
    dR: torch.Tensor        # (3,3)
    dV: torch.Tensor        # (3,)
    dP: torch.Tensor        # (3,)
    cov: torch.Tensor       # (15,15) [phi, v, p, bg, ba]
    JRg: torch.Tensor       # (3,3) d(dR)/d(bg)
    JVg: torch.Tensor       # (3,3)
    JVa: torch.Tensor       # (3,3)
    JPg: torch.Tensor       # (3,3)
    JPa: torch.Tensor       # (3,3)
    bias0: ImuBias          # linearization bias
    avg_acc: torch.Tensor   # (3,) mean specific force
    avg_gyro: torch.Tensor  # (3,)


def stack_preintegrated(pres) -> Preintegrated:
    """A batch (leading axis) of equally-shaped Preintegrated."""
    fields = {f: torch.stack([getattr(p, f) for p in pres])
              for f in Preintegrated._fields if f != "bias0"}
    return Preintegrated(bias0=ImuBias(
        torch.stack([p.bias0.gyro for p in pres]),
        torch.stack([p.bias0.acc for p in pres])), **fields)


def _mv(A, x):
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def preintegrate(acc: torch.Tensor, gyro: torch.Tensor, dts: torch.Tensor,
                 bias: ImuBias, calib: ImuCalib) -> Preintegrated:
    """Integrate a padded float32 window (dt = 0 rows are identity steps).

    acc, gyro: (N, 3); dts: (N,). Position and velocity advance with the
    previous rotation, then the rotation; the covariance propagates with
    the analytic A/B blocks (reference IntegrateNewMeasurement)."""
    dtype, dev = acc.dtype, acc.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros(3, 3, dtype=dtype, device=dev)
    Nga = torch.diag(torch.cat([
        (calib.noise_gyro ** 2).expand(3),
        (calib.noise_acc ** 2).expand(3)])).to(dtype)
    NgaWalk = torch.diag(torch.cat([
        (calib.walk_gyro ** 2).expand(3),
        (calib.walk_acc ** 2).expand(3)])).to(dtype)

    dT = torch.zeros((), dtype=dtype, device=dev)
    dR, dV, dP = eye3, torch.zeros(3, dtype=dtype, device=dev), \
        torch.zeros(3, dtype=dtype, device=dev)
    C = torch.zeros(15, 15, dtype=dtype, device=dev)
    JRg = JVg = JVa = JPg = JPa = z3
    sum_a = sum_w = torch.zeros(3, dtype=dtype, device=dev)
    for k in range(acc.shape[0]):
        a, w, dt = acc[k], gyro[k], dts[k]
        live = dt > 0
        acc_c = a - bias.acc
        gyro_c = w - bias.gyro
        dt2 = dt * dt
        acc_hat = lie.hat(acc_c)

        dP_n = dP + dV * dt + 0.5 * _mv(dR, acc_c) * dt2
        dV_n = dV + _mv(dR, acc_c) * dt

        dRa = dR @ acc_hat
        JPa_n = JPa + JVa * dt - 0.5 * dt2 * dR
        JPg_n = JPg + JVg * dt - 0.5 * dt2 * dRa @ JRg
        JVa_n = JVa - dt * dR
        JVg_n = JVg - dt * dRa @ JRg

        w_dt = gyro_c * dt
        dRi = lie.so3_exp(w_dt)
        rightJ = lie.so3_right_jacobian(w_dt)
        dR_n = dR @ dRi
        A = torch.cat([
            torch.cat([dRi.T, z3, z3], 1),
            torch.cat([-dt * dRa, eye3, z3], 1),
            torch.cat([-0.5 * dt2 * dRa, dt * eye3, eye3], 1)], 0)
        B = torch.cat([
            torch.cat([rightJ * dt, z3], 1),
            torch.cat([z3, dt * dR], 1),
            torch.cat([z3, 0.5 * dt2 * dR], 1)], 0)

        C9 = A @ C[:9, :9] @ A.T + B @ Nga @ B.T
        Cb = C[9:, 9:] + NgaWalk
        C_n = torch.block_diag(C9, Cb)
        JRg_n = dRi.T @ JRg - rightJ * dt

        new = (dT + dt, dR_n, dV_n, dP_n, C_n, JRg_n, JVg_n, JVa_n, JPg_n,
               JPa_n, sum_a + a * dt, sum_w + w * dt)
        old = (dT, dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa, sum_a, sum_w)
        (dT, dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa, sum_a, sum_w) = (
            torch.where(live, n, o) for n, o in zip(new, old))
    dT_safe = torch.clamp(dT, min=1e-9)
    return Preintegrated(
        dT=dT, dR=lie.so3_normalize(dR), dV=dV, dP=dP, cov=C, JRg=JRg,
        JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, bias0=bias,
        avg_acc=sum_a / dT_safe, avg_gyro=sum_w / dT_safe)


def _host_scalars(calib: ImuCalib):
    """The calibration's noise scalars on the host (one transfer)."""
    v = torch.stack([calib.noise_gyro, calib.noise_acc, calib.walk_gyro,
                     calib.walk_acc]).detach().cpu().numpy()
    return (float(x) for x in v)


def preintegrate_host(acc, gyro, dts, bias: ImuBias, calib: ImuCalib,
                      device=None) -> Preintegrated:
    """Float64 host preintegration (numpy), the reference's own lines.

    The per-frame window is a handful of IMU samples, scalar-sequential
    work in double precision as the reference integrates it (float32
    accumulation noise would dominate the ~1e8 inertial information).
    Returns float32 tensors on ``device`` (default: the bias's)."""
    dev = bias.gyro.device if device is None else torch.device(device)
    acc = np.asarray(acc, np.float64)
    gyro = np.asarray(gyro, np.float64)
    dts = np.asarray(dts, np.float64)
    bgba = torch.stack([bias.gyro, bias.acc]).detach().cpu().numpy()
    bg = np.asarray(bgba[0], np.float64)
    ba_ = np.asarray(bgba[1], np.float64)
    ng, na, wg, wa = _host_scalars(calib)
    ng2, na2, wg2, wa2 = ng ** 2, na ** 2, wg ** 2, wa ** 2

    eye3 = np.eye(3)
    dR = np.eye(3)
    dV = np.zeros(3)
    dP = np.zeros(3)
    C = np.zeros((15, 15))
    JRg = np.zeros((3, 3))
    JVg = np.zeros((3, 3))
    JVa = np.zeros((3, 3))
    JPg = np.zeros((3, 3))
    JPa = np.zeros((3, 3))
    dT = 0.0
    sum_a = np.zeros(3)
    sum_w = np.zeros(3)
    Nga = np.diag([ng2] * 3 + [na2] * 3)
    NgaWalk = np.diag([wg2] * 3 + [wa2] * 3)

    def _hat(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                         [-v[1], v[0], 0.0]])

    def _exp(w):
        th = np.linalg.norm(w)
        W = _hat(w)
        if th < 1e-9:
            return eye3 + W + 0.5 * W @ W
        return (eye3 + np.sin(th) / th * W
                + (1 - np.cos(th)) / (th * th) * W @ W)

    def _rightJ(w):
        th = np.linalg.norm(w)
        W = _hat(w)
        if th < 1e-7:
            return eye3 - 0.5 * W
        return (eye3 - (1 - np.cos(th)) / (th * th) * W
                + (th - np.sin(th)) / (th ** 3) * W @ W)

    for k in range(len(dts)):
        dt = dts[k]
        if dt <= 0:
            continue
        a = acc[k] - ba_
        w = gyro[k] - bg
        dt2 = dt * dt
        acc_hat = _hat(a)
        dRa = dR @ acc_hat

        dP = dP + dV * dt + 0.5 * (dR @ a) * dt2
        dV = dV + (dR @ a) * dt

        A = np.zeros((9, 9))
        B = np.zeros((9, 6))
        A[3:6, 0:3] = -dt * dRa
        A[6:9, 0:3] = -0.5 * dt2 * dRa
        A[6:9, 3:6] = dt * eye3
        A[6:9, 6:9] = eye3
        A[3:6, 3:6] = eye3
        B[3:6, 3:6] = dt * dR
        B[6:9, 3:6] = 0.5 * dt2 * dR

        JPa = JPa + JVa * dt - 0.5 * dt2 * dR
        JPg = JPg + JVg * dt - 0.5 * dt2 * dRa @ JRg
        JVa = JVa - dt * dR
        JVg = JVg - dt * dRa @ JRg

        w_dt = w * dt
        dRi = _exp(w_dt)
        rJ = _rightJ(w_dt)
        dR = dR @ dRi
        A[0:3, 0:3] = dRi.T
        B[0:3, 0:3] = rJ * dt

        C[:9, :9] = A @ C[:9, :9] @ A.T + B @ Nga @ B.T
        C[9:, 9:] = C[9:, 9:] + NgaWalk

        JRg = dRi.T @ JRg - rJ * dt
        dT += dt
        sum_a += acc[k] * dt
        sum_w += gyro[k] * dt

    # re-orthonormalize
    u, _, vt = np.linalg.svd(dR)
    dR = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    dT_safe = max(dT, 1e-9)

    def f32(x):
        return torch.from_numpy(np.asarray(np.asarray(x), np.float32)).to(dev)

    return Preintegrated(
        dT=f32(dT), dR=f32(dR), dV=f32(dV), dP=f32(dP), cov=f32(C),
        JRg=f32(JRg), JVg=f32(JVg), JVa=f32(JVa), JPg=f32(JPg),
        JPa=f32(JPa), bias0=bias, avg_acc=f32(sum_a / dT_safe),
        avg_gyro=f32(sum_w / dT_safe))


def bias_corrected_delta(pre: Preintegrated, bias: ImuBias
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-order bias-corrected (dR, dV, dP) at a new bias (reference
    GetDeltaRotation/Velocity/Position); batched over leading axes."""
    dbg = bias.gyro - pre.bias0.gyro
    dba = bias.acc - pre.bias0.acc
    dR = pre.dR @ lie.so3_exp(_mv(pre.JRg, dbg))
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    return dR, dV, dP


def preintegrate_backward(acc: torch.Tensor, gyro: torch.Tensor,
                          dts: torch.Tensor, bias: ImuBias,
                          calib: ImuCalib) -> Preintegrated:
    """Backward preintegration (state i seen from state j): the
    time-reversed window with negated rates and specific force."""
    return preintegrate(-torch.flip(acc, [0]), -torch.flip(gyro, [0]),
                        torch.flip(dts, [0]),
                        ImuBias(-bias.gyro, -bias.acc), calib)


def bias_corrected_delta_backward(pre: Preintegrated, bias: ImuBias):
    """Bias correction of a backward Preintegrated (sign-mapped bias)."""
    return bias_corrected_delta(pre, ImuBias(-bias.gyro, -bias.acc))
