"""Trajectory evaluation: Horn alignment + ATE RMSE (a copy of the
reference's ``orb_slam_fusion_tpu/io/evaluation.py``).

Same protocol as the reference's offline oracle
(evaluation/evaluate_ate_scale.py:49-97): closed-form Horn alignment of the
estimated trajectory to ground truth (optionally with a similarity scale for
monocular runs), then RMSE of the translational residuals. Implemented in
numpy — this is offline tooling, not a device path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def align_horn(est: np.ndarray, gt: np.ndarray, with_scale: bool = True
               ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity aligning est -> gt.

    est, gt: (N, 3). Returns (s, R, t) with gt ~ s * R @ est + t.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    W = gc.T @ ec
    U, d, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum()
        s = float((d * np.diag(S)).sum() / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True
             ) -> float:
    """RMSE absolute trajectory error after Horn alignment."""
    s, R, t = align_horn(est, gt, with_scale)
    aligned = (s * (R @ np.asarray(est, np.float64).T)).T + t
    err = aligned - np.asarray(gt, np.float64)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
