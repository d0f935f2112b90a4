"""TUM-format trajectory IO (a copy of the reference's
``orb_slam_fusion_tpu/io/trajectory.py``).

Reference: System::SaveTrajectoryTUM (src/system.cc:558) writes
`timestamp tx ty tz qx qy qz qw` per line (camera-to-world); the evaluation
scripts and EuRoC ground truths use the same format.
"""

from __future__ import annotations

import numpy as np


def save_tum(path: str, rows: np.ndarray) -> None:
    """rows: (N, 8) = [t, tx, ty, tz, qx, qy, qz, qw]."""
    with open(path, "w") as f:
        for r in np.asarray(rows):
            f.write(f"{r[0]:.6f} " + " ".join(f"{v:.7f}" for v in r[1:]) + "\n")


def load_tum(path: str) -> np.ndarray:
    """Returns (N, 8) array; skips comment lines; accepts csv or whitespace."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) >= 8:
                rows.append([float(p) for p in parts[:8]])
    return np.asarray(rows)
