"""Stereo rectification for unrectified pinhole rigs.

Counterpart of ``orb_slam_fusion_tpu/frontend/rectify.py``. The one-time
part (Bouguet's ``cv::stereoRectify`` with CALIB_ZERO_DISPARITY and
alpha = -1, then ``cv::initUndistortRectifyMap``) is host float64 numpy,
copied from the reference unchanged: ``stereo_rectify`` and
``rectify_map``. The per-frame part, ``remap_bilinear`` (``cv::remap``
INTER_LINEAR, BORDER_CONSTANT 0), runs on the device of its tensors,
rounded as XLA's CPU build of the reference's expression rounds it: each
``a * (1 - f) + b * f`` is a fused multiply-add of the first product onto
the rounded second, computed through float64 (exact product, then one
rounding to float32), so FAST on the remapped images sees the reference's
pixels on the CPU and on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation vector -> matrix (fp64)."""
    th = float(np.linalg.norm(r))
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _rodrigues_inv(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> vector (fp64)."""
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = float(np.arccos(c))
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (th / (2.0 * np.sin(th)))


def _undistort_normalized_np(K: np.ndarray, D: np.ndarray, uv: np.ndarray,
                             iters: int = 20) -> np.ndarray:
    """Pixel -> undistorted normalized coords, fixed-point inverse (numpy)."""
    k1, k2, p1, p2 = [float(v) for v in D[:4]]
    xd = (uv[:, 0] - K[0, 2]) / K[0, 0]
    yd = (uv[:, 1] - K[1, 2]) / K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + k2 * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / rad
        y = (yd - dy) / rad
    return np.stack([x, y], axis=-1)


def stereo_rectify(K1: np.ndarray, D1: np.ndarray, K2: np.ndarray,
                   D2: np.ndarray, R: np.ndarray, t: np.ndarray,
                   size: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bouguet stereo rectification (cv::stereoRectify semantics with
    CALIB_ZERO_DISPARITY, alpha=-1, newImageSize == size).

    R, t: x2 = R @ x1 + t (points from camera-1 frame into camera-2 frame).
    size: (width, height).
    Returns (R1, R2, P1, P2): per-camera rectifying rotations and 3x4 new
    projection matrices.
    """
    w, h = size
    # split the relative rotation evenly between the two cameras
    om = _rodrigues_inv(np.asarray(R, np.float64))
    r_r = _rodrigues(om * -0.5)
    tt = r_r @ np.asarray(t, np.float64).reshape(3)

    # rotate the baseline onto the x (or y) axis
    idx = 0 if abs(tt[0]) > abs(tt[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if tt[idx] > 0 else -1.0
    ww = np.cross(tt, uu)
    nw = np.linalg.norm(ww)
    nt = np.linalg.norm(tt)
    if nw > 0.0:
        ww *= np.arccos(abs(tt[idx]) / nt) / nw
    wR = _rodrigues(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    tnew = R2 @ np.asarray(t, np.float64).reshape(3)

    # common focal length: mean of the vertical focals (OpenCV >= 5
    # semantics; earlier OpenCV used min with a radial-distortion shrink)
    fc_new = 0.5 * (float(np.asarray(K1, np.float64)[1, 1])
                    + float(np.asarray(K2, np.float64)[1, 1]))

    # principal points from the undistorted+rotated image corners
    cc_new = []
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float64)
    for K, D, Rk in ((K1, D1, R1), (K2, D2, R2)):
        xy = _undistort_normalized_np(np.asarray(K, np.float64),
                                      np.asarray(D, np.float64), corners)
        X = np.concatenate([xy, np.ones((4, 1))], axis=1) @ np.asarray(
            Rk, np.float64).T
        pu = fc_new * X[:, 0] / X[:, 2]
        pv = fc_new * X[:, 1] / X[:, 2]
        cc_new.append(np.array([(w - 1) * 0.5 - pu.mean(),
                                (h - 1) * 0.5 - pv.mean()]))
    # CALIB_ZERO_DISPARITY: identical principal points
    cc = (cc_new[0] + cc_new[1]) * 0.5

    P1 = np.array([[fc_new, 0, cc[0], 0],
                   [0, fc_new, cc[1], 0],
                   [0, 0, 1, 0]], np.float64)
    P2 = P1.copy()
    P2[idx, 3] = tnew[idx] * fc_new
    return R1, R2, P1, P2


def rectify_map(K: np.ndarray, D: np.ndarray, R_rect: np.ndarray,
                K_new: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Per-pixel source coordinates for remapping one camera
    (cv::initUndistortRectifyMap semantics). Returns (H, W, 2) float32 of
    raw-image (x, y) for every rectified pixel."""
    w, h = size
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    X = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.asarray(
        R_rect, np.float64)  # == R_rect^T applied to each vector
    xn = X[..., 0] / X[..., 2]
    yn = X[..., 1] / X[..., 2]
    k1, k2, p1, p2 = [float(c) for c in D[:4]]
    r2 = xn * xn + yn * yn
    rad = 1.0 + r2 * (k1 + k2 * r2)
    xd = xn * rad + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * rad + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    mx = K[0, 0] * xd + K[0, 2]
    my = K[1, 1] * yd + K[1, 2]
    return np.stack([mx, my], axis=-1).astype(np.float32)


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor,
          g: torch.Tensor) -> torch.Tensor:
    """float32 ``a * g + b * f`` as fma(a, g, round(b * f))."""
    return (a.double() * g.double() + (b * f).double()).to(torch.float32)


def remap_bilinear(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear resampling: img (H, W) or (..., H, W), map_xy (H', W', 2)
    of source (x, y) per output pixel; taps outside the image read 0."""
    h, w = img.shape[-2], img.shape[-1]
    img = img.to(torch.float32)
    x = map_xy[..., 0]
    y = map_xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return torch.where(inb, img[..., torch.clamp(yi, 0, h - 1),
                                    torch.clamp(xi, 0, w - 1)], zero)

    gx = 1 - fx
    top = _lerp(tap(y0i, x0i), tap(y0i, x0i + 1), fx, gx)
    bot = _lerp(tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1), fx, gx)
    return _lerp(top, bot, fy, 1 - fy)


def remap_stereo_pair(imgL: torch.Tensor, imgR: torch.Tensor,
                      mapL: torch.Tensor, mapR: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both images of a pair through their rectification maps."""
    return remap_bilinear(imgL, mapL), remap_bilinear(imgR, mapR)
