"""Synthetic worlds and sequences: the parts the visual sessions use.

Counterpart of ``orb_slam_fusion_tpu/sim.py`` (``SyntheticWorld``,
``make_corridor_world``, ``world_from_trajectory``, ``render_frame``,
``render_stereo_frame``, ``render_fisheye_stereo_frame``,
``render_image``, ``gt_positions``, and the inertial sessions'
``make_vio_sequence`` and ``vio_from_gt_trajectory``, and
``with_viewdep_descriptors``), for the port's
tests and
``chip_smoke.py``, which run without JAX. Given the same arguments it
returns the reference's arrays bit for bit, so both packages track the
same inputs.

It is host code, numpy only, like the reference's (which draws from
numpy's ``RandomState``; its numpy lines are copied unchanged). The few
float32 steps the reference runs through JAX eagerly are rebuilt here
with the rounding XLA:CPU gives them (jax 0.9.0), one rounding per eager
op:

* ``R @ x`` (``lie.se3_apply``'s einsum) is a chain of fused
  multiply-adds over the 3 terms in increasing index, then ``+ t``;
* ``cameras.project`` is ``fx * x``, ``* (1/z)``, ``+ cx``, each rounded
  (pinhole); the Kannala-Brandt projection runs the port's
  ``cameras.kb8_project`` on the CPU, which rounds each step as XLA's
  eager ops do and takes glibc's ``atan2f``;
* ``lie.so3_exp`` takes XLA:CPU's ``sin``/``cos``, which are glibc's
  ``sinf``/``cosf``: the twins of ``utils/libm.py``;
* ``lie.quat_from_mat`` and ``lie.so3_log`` (``quat_from_mat_f32``,
  ``so3_log_f32``) round each eager op once; ``jnp.linalg.norm`` is a
  fused multiply-add chain of the squares, and ``arctan2`` is glibc's
  ``atan2f``.

A fused multiply-add is computed in float64 (the product of two float32
values is exact there) and rounded once to float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import cameras, resolve_device
from .frontend.extractor import Features
from .map.convert import desc_to_torch
from .utils import libm

f32 = np.float32
PINHOLE = "pinhole"
KANNALA_BRANDT8 = "kannala_brandt8"


class SE3(NamedTuple):
    """Host-side poses: R (..., 3, 3) and t (..., 3) float32 arrays."""

    R: np.ndarray
    t: np.ndarray


class SyntheticWorld(NamedTuple):
    points: np.ndarray        # (P, 3) world points
    descriptors: np.ndarray   # (P, 8) uint32
    poses: SE3                # (T,) ground-truth Tcw per frame
    timestamps: np.ndarray    # (T,)
    ref_dist: Optional[np.ndarray] = None
    quad_desc: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# float32 steps with XLA:CPU's rounding
# ---------------------------------------------------------------------------


def _fma(a, b, c) -> np.ndarray:
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def _matvec(R: np.ndarray, x: np.ndarray) -> np.ndarray:
    """einsum('...ij,...j->...i') in float32: a fused multiply-add chain
    over j = 0, 1, 2."""
    R = np.asarray(R, f32)
    x = np.asarray(x, f32)[..., None, :]
    out = (R[..., 0] * x[..., 0]).astype(f32)
    out = _fma(R[..., 1], x[..., 1], out)
    return _fma(R[..., 2], x[..., 2], out)


def _matmul3(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(..., 3, 3) @ (..., 3, 3) in float32, the same chain per entry."""
    out = (A[..., :, 0, None] * B[..., None, 0, :]).astype(f32)
    out = _fma(A[..., :, 1, None], B[..., None, 1, :], out)
    return _fma(A[..., :, 2, None], B[..., None, 2, :], out)


def se3_apply(pose: SE3, x: np.ndarray) -> np.ndarray:
    return (_matvec(pose.R, x) + pose.t).astype(f32)


def se3_inverse(pose: SE3) -> SE3:
    Rt = np.swapaxes(pose.R, -1, -2)
    return SE3(Rt, -_matvec(Rt, pose.t))


def se3_compose(A: SE3, B: SE3) -> SE3:
    """(A*B)(x) = A(B(x)), rounded as the reference's eager compose."""
    return SE3(_matmul3(np.asarray(A.R, f32), np.asarray(B.R, f32)),
               (_matvec(A.R, B.t) + np.asarray(A.t, f32)).astype(f32))


def project(cam_params, xyz: np.ndarray, cam_model: str = PINHOLE
            ) -> np.ndarray:
    """Projection of camera-frame points, rounded as the reference's eager
    ``cameras.project``."""
    if cam_model == KANNALA_BRANDT8:
        return cameras.kb8_project(
            torch.from_numpy(np.asarray(cam_params, f32)),
            torch.from_numpy(np.asarray(xyz, f32))).numpy()
    if cam_model != PINHOLE:
        raise ValueError(f"unknown camera model {cam_model!r}")
    fx, fy, cx, cy = (f32(v) for v in np.asarray(cam_params, f32)[:4])
    z = xyz[..., 2]
    zi = (f32(1.0) / np.where(np.abs(z) < f32(1e-9), f32(1e-9), z)
          ).astype(f32)
    u = ((fx * xyz[..., 0]).astype(f32) * zi).astype(f32) + cx
    v = ((fy * xyz[..., 1]).astype(f32) * zi).astype(f32) + cy
    return np.stack([u.astype(f32), v.astype(f32)], axis=-1)


def _hat(w: np.ndarray) -> np.ndarray:
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w: np.ndarray) -> np.ndarray:
    """float32 Rodrigues exponential, rounded as the reference's eager
    ``lie.so3_exp`` on XLA:CPU."""
    w = np.asarray(w, f32)
    ww = (w * w).astype(f32)
    th2 = ((ww[..., 0] + ww[..., 1]).astype(f32) + ww[..., 2]).astype(f32)
    small = th2 < f32(1e-8)
    th2s = np.where(small, f32(1.0), th2).astype(f32)
    th = np.sqrt(th2s).astype(f32)
    tht = torch.from_numpy(np.array(th, f32))
    sin = libm.sinf_plain(tht).numpy()
    cos = libm.cosf_plain(tht).numpy()
    a = np.where(small, (f32(1.0) - (th2 / f32(6.0)).astype(f32)),
                 (sin / th).astype(f32)).astype(f32)
    b = np.where(small, (f32(0.5) - (th2 / f32(24.0)).astype(f32)),
                 ((f32(1.0) - cos).astype(f32) / (th * th).astype(f32))
                 ).astype(f32)
    W = _hat(w)
    W2 = _matmul3(W, W)
    eye = np.broadcast_to(np.eye(3, dtype=f32), W.shape)
    aW = (a[..., None, None] * W).astype(f32)
    bW2 = (b[..., None, None] * W2).astype(f32)
    return ((eye + aW).astype(f32) + bW2).astype(f32)


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------


def make_quadrant_descriptors(desc: np.ndarray, rng: np.random.RandomState,
                              drift_bits: int = 80) -> np.ndarray:
    """(P, 8) base descriptors -> (P, 4, 8) per-view-quadrant variants."""
    P = desc.shape[0]
    out = np.empty((P, 4, 8), np.uint32)
    for q in range(4):
        mask = np.zeros((P, 256), bool)
        cols = rng.randint(0, 256, (P, drift_bits))
        mask[np.arange(P)[:, None], cols] = True
        words = np.packbits(mask.reshape(P, 8, 32),
                            axis=-1, bitorder='little')
        xor = words.view(np.uint32).reshape(P, 8)
        out[:, q] = desc ^ (xor if q else 0)
    return out


def _view_quadrant(view_dir: np.ndarray) -> np.ndarray:
    """(N, 3) point->camera directions -> (N,) quadrant index 0..3."""
    ang = np.arctan2(view_dir[:, 1], view_dir[:, 0])
    return ((ang + np.pi) / (np.pi / 2.0)).astype(np.int64) % 4


def _canonical_distances(pts: np.ndarray, cam_positions: np.ndarray,
                         rng: np.random.RandomState) -> np.ndarray:
    """ref_dist per point: its distance from the trajectory centroid pushed
    up by a random 0-3 octave margin."""
    centroid = np.asarray(cam_positions, np.float64).mean(axis=0)
    d = np.linalg.norm(pts - centroid[None, :], axis=1)
    return (d * 1.2 ** rng.uniform(0.0, 3.0, len(pts))).astype(np.float32)


def make_corridor_world(n_frames: int = 120, n_points: int = 4000,
                        seed: int = 0, fps: float = 20.0,
                        motion: str = "arc") -> SyntheticWorld:
    """Points in a corridor volume; camera advances with gentle yaw/sway."""
    rng = np.random.RandomState(seed)
    if motion == "circle":
        pts = np.stack([
            rng.uniform(-9.0, 9.0, n_points),
            rng.uniform(-2.5, 2.5, n_points),
            rng.uniform(-6.0, 12.0, n_points),
        ], axis=1).astype(np.float32)
    else:
        length = 3.0 + 0.25 * n_frames
        pts = np.stack([
            rng.uniform(-4.0, 4.0, n_points),
            rng.uniform(-2.5, 2.5, n_points),
            rng.uniform(0.0, length, n_points),
        ], axis=1).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, size=(n_points, 8), dtype=np.uint64)
    desc = desc.astype(np.uint32)

    Rs, ts = [], []
    for k in range(n_frames):
        s = k / max(n_frames - 1, 1)
        if motion == "arc":
            pos_w = np.array([
                0.8 * np.sin(2.0 * np.pi * s),
                0.2 * np.sin(4.0 * np.pi * s),
                0.18 * k,
            ])
            yaw = 0.15 * np.sin(2.0 * np.pi * s)
            pitch = 0.05 * np.sin(4.0 * np.pi * s)
            w = np.array([pitch, yaw, 0.0], np.float32)
        elif motion == "circle":
            ang = 2.0 * np.pi * s
            r_c = 3.0
            pos_w = np.array([r_c * np.sin(ang), 0.0,
                              r_c * (1 - np.cos(ang))])
            w = np.array([0.0, np.pi / 2 - ang, 0.0], np.float32)
        else:  # straight
            pos_w = np.array([0.0, 0.0, 0.18 * k])
            w = np.zeros(3, np.float32)
        R_wc = so3_exp(w)
        R_cw = R_wc.T
        t_cw = -R_cw @ pos_w
        Rs.append(R_cw)
        ts.append(t_cw)
    poses = SE3(np.stack(Rs).astype(f32), np.stack(ts).astype(f32))
    timestamps = np.arange(n_frames) / fps
    cam_pos = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
    return SyntheticWorld(pts, desc, poses, timestamps,
                          _canonical_distances(pts, cam_pos, rng))


def quat_to_mat(qv):
    """wxyz quaternion -> rotation matrix (R_wb for GT body quats)."""
    w, x, y, z = qv
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _norm_f32(v: np.ndarray) -> np.ndarray:
    """``jnp.linalg.norm`` over the last axis: a fused multiply-add chain
    of the squares in index order, then the square root."""
    x = np.asarray(v, f32).astype(np.float64)
    acc = (x[..., 0] * x[..., 0]).astype(f32)
    for i in range(1, x.shape[-1]):
        acc = (acc.astype(np.float64) + x[..., i] * x[..., i]).astype(f32)
    return np.sqrt(acc).astype(f32)


def quat_from_mat_f32(R: np.ndarray) -> np.ndarray:
    """The reference's eager float32 ``lie.quat_from_mat`` of one (3, 3)
    rotation: Shepperd's four candidates, the largest pivot's chosen
    (the first on ties), w >= 0, normalized."""
    R = np.asarray(R, f32)
    m = [[R[i, j] for j in range(3)] for i in range(3)]
    one, two = f32(1.0), f32(2.0)
    tr = f32(f32(m[0][0] + m[1][1]) + m[2][2])

    def piv(a, b, c):
        return f32(f32(f32(one + a) - b) - c)

    pivots = [f32(one + tr), piv(m[0][0], m[1][1], m[2][2]),
              f32(f32(f32(one - m[0][0]) + m[1][1]) - m[2][2]),
              f32(f32(f32(one - m[0][0]) - m[1][1]) + m[2][2])]
    d21, d02, d10 = (f32(m[2][1] - m[1][2]), f32(m[0][2] - m[2][0]),
                     f32(m[1][0] - m[0][1]))
    s01, s02, s12 = (f32(m[0][1] + m[1][0]), f32(m[0][2] + m[2][0]),
                     f32(m[1][2] + m[2][1]))
    comps = [(pivots[0], d21, d02, d10), (d21, pivots[1], s01, s02),
             (d02, s01, pivots[2], s12), (d10, s02, s12, pivots[3])]
    k = int(np.argmax(np.array(pivots, f32)))
    sc = f32(np.sqrt(f32(max(pivots[k], f32(1e-8)))) * two)
    q = np.array([f32(c / sc) for c in comps[k]], f32)
    if q[0] < 0:
        q = (q * f32(-1.0)).astype(f32)
    return (q / _norm_f32(q)).astype(f32)


def so3_log_f32(R: np.ndarray) -> np.ndarray:
    """The reference's eager float32 ``lie.so3_log`` of one rotation
    (quaternion route; glibc's ``atan2f``)."""
    from .utils.libm import atan2 as atan2f
    q = quat_from_mat_f32(R)
    w, v = q[0], q[1:]
    vnorm = _norm_f32(v)
    ang = atan2f(torch.tensor([vnorm]), torch.tensor([w])).numpy()[0]
    angle = f32(f32(2.0) * ang)
    if vnorm < f32(1e-6):
        factor = f32(f32(2.0) / max(w, f32(1e-8)))
    else:
        factor = f32(angle / vnorm)
    return (v * factor).astype(f32)


def world_from_trajectory(positions: np.ndarray, n_points: int = 6000,
                          seed: int = 0,
                          timestamps: Optional[np.ndarray] = None,
                          point_margin: float = 3.0,
                          quats_wxyz: Optional[np.ndarray] = None
                          ) -> SyntheticWorld:
    """A world around a given trajectory: points fill its bounding volume
    with a margin; the camera carries ``quats_wxyz`` when given, else looks
    along the rate-limited direction of travel."""
    rng = np.random.RandomState(seed)
    positions = np.asarray(positions, np.float64)
    T = len(positions)
    lo = positions.min(axis=0) - point_margin
    hi = positions.max(axis=0) + point_margin
    pts = rng.uniform(lo, hi, size=(n_points, 3)).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, size=(n_points, 8),
                       dtype=np.uint64).astype(np.uint32)

    if quats_wxyz is not None:
        Rs, ts = [], []
        for i in range(T):
            R_cw = quat_to_mat(np.asarray(quats_wxyz[i], np.float64)).T
            Rs.append(R_cw)
            ts.append(-R_cw @ positions[i])
        poses = SE3(np.stack(Rs).astype(f32), np.stack(ts).astype(f32))
        if timestamps is None:
            timestamps = np.arange(T) / 20.0
        return SyntheticWorld(pts, desc, poses, np.asarray(timestamps),
                              _canonical_distances(pts, positions, rng))

    vel = np.gradient(positions, axis=0)
    k = np.ones(15) / 15.0
    vel = np.stack([np.convolve(vel[:, i], k, mode="same")
                    for i in range(3)], axis=1)
    speeds = np.linalg.norm(vel, axis=1)
    speed_th = max(1e-6, 0.2 * np.median(speeds[speeds > 1e-9])
                   if np.any(speeds > 1e-9) else 1e-6)
    good = np.nonzero(speeds > speed_th)[0]
    z_prev = (vel[good[0]] / speeds[good[0]]) if len(good) else \
        np.array([1.0, 0.0, 0.0])
    up = np.array([0.0, 0.0, 1.0])
    x0 = np.cross(z_prev, up)
    if np.linalg.norm(x0) < 1e-6:
        x0 = np.array([0.0, 1.0, 0.0])
    x0 = x0 / np.linalg.norm(x0)
    R_wc = np.stack([x0, np.cross(z_prev, x0), z_prev], axis=1)
    max_step = 0.05
    Rs, ts = [], []
    for i in range(T):
        if speeds[i] > speed_th:
            z_new = vel[i] / speeds[i]
            z_cur = R_wc[:, 2]
            axis = np.cross(z_cur, z_new)
            na = np.linalg.norm(axis)
            ang = float(np.arctan2(na, np.clip(z_cur @ z_new, -1, 1)))
            if na > 1e-9 and ang > 1e-6:
                step = min(ang, max_step)
                w = axis / na * step
                R_step = so3_exp(w.astype(np.float32))
                R_wc = R_step @ R_wc
        R_cw = R_wc.T
        Rs.append(R_cw.copy())
        ts.append(-R_cw @ positions[i])
    poses = SE3(np.stack(Rs).astype(f32), np.stack(ts).astype(f32))
    if timestamps is None:
        timestamps = np.arange(T) / 20.0
    return SyntheticWorld(pts, desc, poses, np.asarray(timestamps),
                          _canonical_distances(pts, positions, rng))


class VioSequence(NamedTuple):
    world: SyntheticWorld          # points/descriptors/frame poses (camera)
    frame_imu: list                # per frame: (acc (N,3), gyro (N,3), t (N,))
    vel: np.ndarray                # (T,3) GT body velocity in world
    gravity: np.ndarray            # (3,)
    gyro_bias_true: np.ndarray = np.zeros(3)   # injected sensor biases
    acc_bias_true: np.ndarray = np.zeros(3)


def make_vio_sequence(n_frames: int = 120, fps: float = 20.0,
                      imu_rate: float = 200.0, n_points: int = 5000,
                      seed: int = 0, gyro_noise: float = 0.0,
                      acc_noise: float = 0.0, gyro_bias: float = 0.0,
                      acc_bias: float = 0.0) -> VioSequence:
    """Monocular-inertial synthetic sequence with exactly consistent IMU:
    body accelerations and rates sampled at IMU rate and Euler-integrated
    into the frame poses (camera = body, world z up). The rotation step is
    the reference's eager float32 ``so3_exp`` of ``w_b * dt`` (rounded from
    float64 first), chained into a float64 ``R @ Rtmp``."""
    rng = np.random.RandomState(seed)
    g_w = np.array([0.0, 0.0, -9.81])
    dt = 1.0 / imu_rate
    n_imu = int(round(imu_rate / fps))
    total = n_frames * n_imu

    # analytic body-rate / world-acceleration profiles (gentle flight)
    tt = np.arange(total) * dt
    T_total = n_frames / fps
    a_w = np.stack([
        0.6 * np.sin(2 * np.pi * tt / T_total * 2.0),
        0.4 * np.sin(2 * np.pi * tt / T_total * 3.0 + 1.0),
        0.3 * np.sin(2 * np.pi * tt / T_total * 1.5 + 2.0),
    ], axis=1)
    w_b = np.stack([
        0.10 * np.sin(2 * np.pi * tt / T_total * 1.0),
        0.25 * np.sin(2 * np.pi * tt / T_total * 0.5),
        0.05 * np.sin(2 * np.pi * tt / T_total * 2.0 + 0.7),
    ], axis=1)

    bg = rng.randn(3) * gyro_bias
    ba_ = rng.randn(3) * acc_bias

    R = np.eye(3)
    p = np.zeros(3)
    v = np.array([0.25, 0.05, 0.6])   # initial velocity (forward = +z-ish)
    Rs, ts, vels = [], [], []
    accs = np.zeros((total, 3))
    gyros = np.zeros((total, 3))
    for k in range(total):
        if k % n_imu == 0:
            Rs.append(R.T.copy())            # R_cw = R_wb^T (cam = body)
            ts.append((-R.T @ p).copy())
            vels.append(v.copy())
        accs[k] = R.T @ (a_w[k] - g_w) + ba_ \
            + rng.randn(3) * acc_noise
        gyros[k] = w_b[k] + bg + rng.randn(3) * gyro_noise
        p = p + v * dt + 0.5 * a_w[k] * dt * dt
        v = v + a_w[k] * dt
        Rtmp = so3_exp(np.asarray(w_b[k] * dt, f32))
        R = R @ Rtmp

    poses = SE3(np.stack(Rs).astype(f32), np.stack(ts).astype(f32))
    timestamps = np.arange(n_frames) / fps

    # world points around the traversed volume
    centers = -np.einsum("kji,kj->ki", np.stack(Rs), np.stack(ts))
    lo = centers.min(axis=0) - 4.0
    hi = centers.max(axis=0) + 4.0
    hi[2] = max(hi[2], lo[2] + 12.0)
    pts = rng.uniform(lo, hi, size=(n_points, 3)).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, size=(n_points, 8),
                       dtype=np.uint64).astype(np.uint32)
    world = SyntheticWorld(pts, desc, poses, timestamps,
                           _canonical_distances(pts, centers, rng))

    frame_imu = []
    for f in range(n_frames):
        sl = slice(f * n_imu, (f + 1) * n_imu)
        t_meas = tt[sl] + dt  # measurement timestamps (end of each step)
        frame_imu.append((accs[sl].astype(np.float32),
                          gyros[sl].astype(np.float32),
                          t_meas.astype(np.float64)))
    return VioSequence(world=world, frame_imu=frame_imu,
                       vel=np.stack(vels), gravity=g_w,
                       gyro_bias_true=bg, acc_bias_true=ba_)


def with_viewdep_descriptors(world: SyntheticWorld, seed: int = 0,
                             drift_bits: int = 80) -> SyntheticWorld:
    """Equip a world with viewpoint-dependent (per-view-quadrant)
    descriptors (``SyntheticWorld.quad_desc``)."""
    rng = np.random.RandomState(seed ^ 0x5EED)
    return world._replace(quad_desc=make_quadrant_descriptors(
        world.descriptors, rng, drift_bits))


def vio_from_gt_trajectory(positions: np.ndarray, quats_wxyz: np.ndarray,
                           timestamps: np.ndarray, imu_rate: float = 200.0,
                           n_points: int = 8000, seed: int = 0,
                           gyro_noise: float = 0.0, acc_noise: float = 0.0,
                           gyro_bias: float = 0.0, acc_bias: float = 0.0,
                           point_margin: float = 3.0) -> VioSequence:
    """Inertial sequence along a ground-truth trajectory (positions and
    R_wb quaternions at frame rate): cubic positions and slerped
    orientations at IMU rate, then IMU samples that Euler-integrate
    exactly into them (camera = body, gravity -9.81 z). The reference's
    numpy lines, with its eager float32 ``so3_log`` of each step's
    rotation rebuilt by ``so3_log_f32``."""
    from scipy.interpolate import CubicSpline

    rng = np.random.RandomState(seed)
    g_w = np.array([0.0, 0.0, -9.81])
    t = np.asarray(timestamps, np.float64)
    t = t - t[0]
    fps = (len(t) - 1) / max(t[-1], 1e-9)
    n_imu = int(round(imu_rate / fps))
    dt = (t[-1] - t[0]) / ((len(t) - 1) * n_imu)
    n_frames = len(t)
    total = (n_frames - 1) * n_imu + 1
    tt = np.arange(total) * dt

    p_spline = CubicSpline(t, np.asarray(positions, np.float64), axis=0)
    p_hi = p_spline(tt)

    q = np.asarray(quats_wxyz, np.float64)
    for k in range(1, len(q)):
        if np.dot(q[k], q[k - 1]) < 0:
            q[k] = -q[k]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    idx = np.clip(np.searchsorted(t, tt, side="right") - 1, 0, n_frames - 2)
    u = (tt - t[idx]) / np.maximum(t[idx + 1] - t[idx], 1e-9)
    q0, q1 = q[idx], q[idx + 1]
    dotq = np.clip(np.sum(q0 * q1, axis=1, keepdims=True), -1.0, 1.0)
    ang = np.arccos(dotq)
    small = ang[:, 0] < 1e-6
    w0 = np.where(small[:, None], 1 - u[:, None],
                  np.sin((1 - u[:, None]) * ang) / np.maximum(np.sin(ang),
                                                              1e-12))
    w1 = np.where(small[:, None], u[:, None],
                  np.sin(u[:, None] * ang) / np.maximum(np.sin(ang), 1e-12))
    q_hi = q0 * w0 + q1 * w1
    q_hi /= np.linalg.norm(q_hi, axis=1, keepdims=True)
    R_hi = np.stack([quat_to_mat(qv) for qv in q_hi])   # R_wb

    bg = rng.randn(3) * gyro_bias
    ba_ = rng.randn(3) * acc_bias
    v = (p_hi[1] - p_hi[0]) / dt
    accs = np.zeros((total - 1, 3))
    gyros = np.zeros((total - 1, 3))
    vels_frame = []
    Rs_cw, ts_cw = [], []
    for k in range(total - 1):
        if k % n_imu == 0:
            Rs_cw.append(R_hi[k].T)
            ts_cw.append(-R_hi[k].T @ p_hi[k])
            vels_frame.append(v.copy())
        a_w = 2.0 * (p_hi[k + 1] - p_hi[k] - v * dt) / (dt * dt)
        dR = R_hi[k].T @ R_hi[k + 1]
        w_b = so3_log_f32(dR.astype(f32)) / dt
        accs[k] = R_hi[k].T @ (a_w - g_w) + ba_ + rng.randn(3) * acc_noise
        gyros[k] = w_b + bg + rng.randn(3) * gyro_noise
        v = v + a_w * dt
    Rs_cw.append(R_hi[-1].T)
    ts_cw.append(-R_hi[-1].T @ p_hi[-1])
    vels_frame.append(v.copy())

    poses = SE3(np.stack(Rs_cw).astype(f32), np.stack(ts_cw).astype(f32))
    lo = p_hi.min(axis=0) - point_margin
    hi = p_hi.max(axis=0) + point_margin
    pts = rng.uniform(lo, hi, size=(n_points, 3)).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, size=(n_points, 8),
                       dtype=np.uint64).astype(np.uint32)
    world = SyntheticWorld(pts, desc, poses,
                           (t[: n_frames]).astype(np.float64),
                           _canonical_distances(pts, p_hi[::n_imu], rng))
    # frame_imu[f] covers (t[f], t[f+1]], as make_vio_sequence's
    frame_imu = []
    for f in range(n_frames):
        sl = slice(f * n_imu, min((f + 1) * n_imu, total - 1))
        t_meas = tt[sl.start:sl.stop] + dt
        frame_imu.append((accs[sl].astype(np.float32),
                          gyros[sl].astype(np.float32),
                          t_meas.astype(np.float64)))
    return VioSequence(world=world, frame_imu=frame_imu,
                       vel=np.stack(vels_frame), gravity=g_w,
                       gyro_bias_true=bg, acc_bias_true=ba_)


def gt_positions(world: SyntheticWorld) -> np.ndarray:
    """Ground-truth camera centers (T, 3) in world coords."""
    return se3_inverse(world.poses).t


def _frame_pose(world: SyntheticWorld, frame: int,
                pose_override: Optional[SE3]) -> SE3:
    if pose_override is not None:
        return SE3(np.asarray(pose_override.R, f32),
                   np.asarray(pose_override.t, f32))
    return SE3(world.poses.R[frame], world.poses.t[frame])


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def render_frame_numpy(world: SyntheticWorld, frame: int, cam_params,
                       image_size: Tuple[int, int], n_features: int,
                       pixel_noise: float = 0.4, desc_bit_flips: int = 4,
                       dropout: float = 0.1, seed: int = 0,
                       cam_model: str = PINHOLE,
                       pose_override: Optional[SE3] = None):
    """``render_frame``'s arrays on the host: a dict of the Features
    fields as numpy arrays (descriptors uint32)."""
    rng = np.random.RandomState(seed * 100003 + frame)
    h, w = image_size
    pose = _frame_pose(world, frame, pose_override)
    pc = se3_apply(pose, world.points)
    uv = project(cam_params, pc, cam_model)
    vis = (pc[:, 2] > 0.3) & (pc[:, 2] < 40.0) \
        & (uv[:, 0] >= 8) & (uv[:, 0] < w - 8) \
        & (uv[:, 1] >= 8) & (uv[:, 1] < h - 8)
    vis &= rng.rand(len(vis)) > dropout
    saliency_rng = np.random.RandomState(9177)
    saliency = saliency_rng.rand(len(world.points))
    idx = np.nonzero(vis)[0]
    idx = idx[np.argsort(-saliency[idx])][:n_features]
    rng.shuffle(idx)
    n = len(idx)

    uv_obs = uv[idx] + rng.randn(n, 2).astype(np.float32) * pixel_noise
    if world.ref_dist is not None:
        dist = np.linalg.norm(pc[idx], axis=1)
        octv = np.round(np.log(world.ref_dist[idx] /
                               np.maximum(dist, 1e-6)) / np.log(1.2))
        octv += (rng.rand(n) < 0.15) * rng.choice([-1, 1], n)
        octv = np.clip(octv, 0, 7).astype(np.int32)
    else:
        octv = np.zeros(n, np.int32)
    if world.quad_desc is not None:
        C = se3_apply(se3_inverse(pose), np.zeros(3, f32))
        vdir = C[None, :] - world.points[idx]
        quad = _view_quadrant(vdir)
        desc = world.quad_desc[idx, quad].copy()
    else:
        desc = world.descriptors[idx].copy()
    if desc_bit_flips > 0:
        for _ in range(desc_bit_flips):
            word = rng.randint(0, 8, n)
            bit = rng.randint(0, 32, n).astype(np.uint32)
            desc[np.arange(n), word] ^= (np.uint32(1) << bit)

    f_uv = np.zeros((n_features, 2), np.float32)
    f_desc = np.zeros((n_features, 8), np.uint32)
    f_oct = np.zeros(n_features, np.int32)
    f_val = np.zeros(n_features, bool)
    f_uv[:n] = uv_obs
    f_desc[:n] = desc
    f_oct[:n] = octv
    f_val[:n] = True
    return dict(uv=f_uv, response=f_val.astype(np.float32), octave=f_oct,
                angle=np.zeros(n_features, np.float32), desc=f_desc,
                valid=f_val)


def render_frame(world: SyntheticWorld, frame: int, cam_params,
                 image_size: Tuple[int, int], n_features: int,
                 pixel_noise: float = 0.4, desc_bit_flips: int = 4,
                 dropout: float = 0.1, seed: int = 0,
                 cam_model: str = PINHOLE,
                 pose_override: Optional[SE3] = None, device=None
                 ) -> Features:
    """Observe the world from frame's GT pose -> fixed-capacity Features
    on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    return features_on(render_frame_numpy(
        world, frame, cam_params, image_size, n_features, pixel_noise,
        desc_bit_flips, dropout, seed, cam_model, pose_override), dev)


def features_on(a: dict, device) -> Features:
    """``render_frame_numpy``'s arrays as Features on ``device``."""
    return Features(**{k: (desc_to_torch(v, device) if k == "desc"
                           else torch.from_numpy(v).to(device))
                       for k, v in a.items()})


def stereo_right_pose(world: SyntheticWorld, frame: int,
                      baseline: float) -> SE3:
    """The right camera of a rectified pair, displaced by ``baseline``
    along the left camera's x axis: T_rw = (I, [-b, 0, 0]) o T_lw."""
    return SE3(world.poses.R[frame],
               (world.poses.t[frame]
                + np.array([-baseline, 0.0, 0.0], f32)).astype(f32))


def render_stereo_frame_numpy(world: SyntheticWorld, frame: int, cam_params,
                              image_size, n_features: int, baseline: float,
                              seed: int = 0, **kw):
    """``render_stereo_frame``'s arrays on the host: (left, right) dicts."""
    fL = render_frame_numpy(world, frame, cam_params, image_size,
                            n_features, seed=seed, **kw)
    fR = render_frame_numpy(world, frame, cam_params, image_size,
                            n_features, seed=seed + 1,
                            pose_override=stereo_right_pose(world, frame,
                                                            baseline), **kw)
    return fL, fR


def render_stereo_frame(world: SyntheticWorld, frame: int, cam_params,
                        image_size, n_features: int, baseline: float,
                        seed: int = 0, device=None, **kw):
    """A rectified stereo pair of Features: the right camera displaced by
    ``baseline`` along the left camera's x axis. Returns (featsL, featsR)."""
    dev = resolve_device(device)
    return tuple(features_on(a, dev) for a in render_stereo_frame_numpy(
        world, frame, cam_params, image_size, n_features, baseline, seed,
        **kw))


def fisheye_right_pose(world: SyntheticWorld, frame: int, T_c1_c2) -> SE3:
    """The second camera of a rig with extrinsics ``T_c1_c2`` (4x4)."""
    T12 = np.asarray(T_c1_c2, f32)
    R21 = np.ascontiguousarray(T12[:3, :3].T)
    t21 = _matvec(-R21, T12[:3, 3])
    return se3_compose(SE3(R21, t21), SE3(world.poses.R[frame],
                                          world.poses.t[frame]))


def render_fisheye_stereo_frame_numpy(world: SyntheticWorld, frame: int,
                                      cam1, cam2, image_size,
                                      n_features: int, T_c1_c2,
                                      seed: int = 0, **kw):
    """``render_fisheye_stereo_frame``'s arrays on the host."""
    fL = render_frame_numpy(world, frame, cam1, image_size, n_features,
                            seed=seed, cam_model=KANNALA_BRANDT8, **kw)
    fR = render_frame_numpy(world, frame, cam2, image_size, n_features,
                            seed=seed + 1, cam_model=KANNALA_BRANDT8,
                            pose_override=fisheye_right_pose(world, frame,
                                                             T_c1_c2), **kw)
    return fL, fR


def render_fisheye_stereo_frame(world: SyntheticWorld, frame: int, cam1,
                                cam2, image_size, n_features: int, T_c1_c2,
                                seed: int = 0, device=None, **kw):
    """A non-rectified fisheye pair (two KB8 cameras related by the rig
    extrinsics ``T_c1_c2``). Returns (featsL, featsR)."""
    dev = resolve_device(device)
    return tuple(features_on(a, dev)
                 for a in render_fisheye_stereo_frame_numpy(
                     world, frame, cam1, cam2, image_size, n_features,
                     T_c1_c2, seed, **kw))


def _landmark_textures(n_points: int, seed: int = 4242,
                       cells: int = 6) -> np.ndarray:
    """Persistent per-landmark texture patches: (P, cells, cells) in
    [0, 1], blocky with a directional ramp and a per-landmark amplitude."""
    rng = np.random.RandomState(seed)
    tex = (rng.rand(n_points, cells, cells) > 0.5).astype(np.float32)
    ang = rng.rand(n_points, 1, 1) * 2 * np.pi
    yy, xx = np.mgrid[0:cells, 0:cells].astype(np.float32)
    yy = (yy / (cells - 1) - 0.5)[None]
    xx = (xx / (cells - 1) - 0.5)[None]
    ramp = xx * np.cos(ang) + yy * np.sin(ang) + 0.5
    tex = 0.45 * tex + 0.55 * np.clip(ramp, 0, 1)
    amp = 0.45 + 0.55 * rng.rand(n_points, 1, 1)
    return (tex * amp).astype(np.float32)


_TEX_CACHE: dict = {}


def render_image(world: SyntheticWorld, frame: int, cam_params,
                 image_size: Tuple[int, int], seed: int = 0,
                 cam_model: str = PINHOLE,
                 pose_override: Optional[SE3] = None, bg_noise: float = 3.0,
                 base_px: float = 18.0, max_points: int = 1500,
                 center_marker: bool = False) -> np.ndarray:
    """(H, W) float32 grayscale image of the world from frame's GT pose:
    each visible landmark splatted as its persistent texture patch, sized
    by its distance against its canonical range."""
    rng = np.random.RandomState(seed * 70001 + frame)
    h, w = image_size
    pose = _frame_pose(world, frame, pose_override)
    pc = se3_apply(pose, world.points)
    uv = project(cam_params, pc, cam_model)
    vis = (pc[:, 2] > 0.3) & (pc[:, 2] < 40.0) \
        & (uv[:, 0] >= 4) & (uv[:, 0] < w - 4) \
        & (uv[:, 1] >= 4) & (uv[:, 1] < h - 4)
    idx = np.nonzero(vis)[0]
    if len(idx) > max_points:
        saliency = np.random.RandomState(9177).rand(len(world.points))
        idx = idx[np.argsort(-saliency[idx])][:max_points]

    key = len(world.points)
    if key not in _TEX_CACHE:
        _TEX_CACHE[key] = _landmark_textures(len(world.points))
    tex = _TEX_CACHE[key]

    img = rng.randn(h, w).astype(np.float32) * bg_noise + 64.0
    ref = (world.ref_dist if world.ref_dist is not None
           else np.full(len(world.points), 6.0, np.float32))
    dist = np.linalg.norm(pc[idx], axis=1)
    sizes = np.clip(base_px * ref[idx] / np.maximum(dist, 1e-6),
                    6, 64).astype(np.int32)
    order = np.argsort(-dist)
    for i in order:
        p = idx[i]
        s = int(sizes[i])
        cu, cv = uv[p]
        u0 = int(round(cu)) - s // 2
        v0 = int(round(cv)) - s // 2
        u1, v1 = u0 + s, v0 + s
        cu0, cv0 = max(u0, 0), max(v0, 0)
        cu1, cv1 = min(u1, w), min(v1, h)
        if cu1 <= cu0 or cv1 <= cv0:
            continue
        C = tex.shape[1]
        fy = (np.arange(cv0, cv1) - v0 + 0.5) / s * (C - 1)
        fx = (np.arange(cu0, cu1) - u0 + 0.5) / s * (C - 1)
        y0 = np.clip(fy.astype(np.int32), 0, C - 2)
        x0 = np.clip(fx.astype(np.int32), 0, C - 2)
        wy = (fy - y0)[:, None]
        wx = (fx - x0)[None, :]
        tp = tex[p]
        patch = (tp[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
                 + tp[np.ix_(y0 + 1, x0)] * wy * (1 - wx)
                 + tp[np.ix_(y0, x0 + 1)] * (1 - wy) * wx
                 + tp[np.ix_(y0 + 1, x0 + 1)] * wy * wx)
        img[cv0:cv1, cu0:cu1] = 64.0 + patch * 130.0
        if not center_marker:
            continue
        cs = max(2, s // 10)
        hi, lo = (224.0, 32.0) if (p & 1) == 0 else (32.0, 224.0)
        ju0, jv0 = int(round(cu)) - cs, int(round(cv)) - cs
        for (qy, qx, val) in ((0, 0, hi), (0, 1, lo),
                              (1, 0, lo), (1, 1, hi)):
            a0 = max(jv0 + qy * cs, 0)
            a1 = min(jv0 + (qy + 1) * cs, h)
            b0 = max(ju0 + qx * cs, 0)
            b1 = min(ju0 + (qx + 1) * cs, w)
            if a1 > a0 and b1 > b0:
                img[a0:a1, b0:b1] = val
    return np.clip(img, 0.0, 255.0)
