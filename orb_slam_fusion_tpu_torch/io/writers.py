"""Additional trajectory writers: EuRoC and KITTI formats.

Counterpart of ``orb_slam_fusion_tpu/io/writers.py`` (reference:
System::SaveTrajectoryEuRoC, src/system.cc:680 — TUM-style lines with
nanosecond timestamps — and System::SaveTrajectoryKITTI, src/system.cc:1161
— 3x4 row-major pose matrices). Host numpy; poses are the port's
``lie.SE3`` of tensors.
"""

from __future__ import annotations

import numpy as np


def save_euroc(path: str, rows: np.ndarray) -> None:
    """rows: (N, 8) = [t_sec, tx, ty, tz, qx, qy, qz, qw]; EuRoC uses ns."""
    with open(path, "w") as f:
        for r in np.asarray(rows):
            f.write(f"{int(round(r[0] * 1e9))} "
                    + " ".join(f"{v:.7f}" for v in r[1:]) + "\n")


def save_kitti(path: str, poses_twc: list) -> None:
    """poses_twc: list of SE3 (camera-to-world); writes 3x4 row-major."""
    with open(path, "w") as f:
        for T in poses_twc:
            R = T.R.detach().cpu().numpy()
            t = T.t.detach().cpu().numpy()
            M = np.concatenate([R, t[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")
