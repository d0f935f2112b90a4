"""EuRoC MAV dataset reader.

Counterpart of ``orb_slam_fusion_tpu/io/euroc.py`` (reference: the EuRoC
runner tests/slam_euroc_si.cc: LoadImages, LoadIMU and the per-frame IMU
batches). The JAX package parses the CSV files and associates timestamps
through its native C++ library when it is built and falls back to numpy;
the port keeps only the numpy routines (``parse_euroc_imu``,
``parse_euroc_cam``, ``associate``, after ``native_bridge.py``'s Python
branches). Images are decoded with OpenCV, imported inside ``load_gray``
only: the reader itself needs numpy alone.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np


def parse_euroc_imu(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``imu0/data.csv`` -> (t (N,) seconds float64, gyro (N, 3), acc (N, 3)
    float32)."""
    rows = np.loadtxt(path, delimiter=",", comments="#")
    return (rows[:, 0] * 1e-9, rows[:, 1:4].astype(np.float32),
            rows[:, 4:7].astype(np.float32))


def parse_euroc_cam(path: str) -> Tuple[np.ndarray, list]:
    """``camN/data.csv`` -> (t (N,) seconds, file names)."""
    t_list, names = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            ts, name = line.strip().split(",")[:2]
            t_list.append(float(ts) * 1e-9)
            names.append(name)
    return np.asarray(t_list), names


def associate(query_t: np.ndarray, ref_t: np.ndarray,
              max_dt: float = 0.02) -> np.ndarray:
    """Nearest-timestamp association (sorted inputs); -1 where unmatched."""
    query_t = np.ascontiguousarray(query_t, np.float64)
    ref_t = np.ascontiguousarray(ref_t, np.float64)
    out = np.full(len(query_t), -1, np.int64)
    for i, q in enumerate(query_t):
        j = np.searchsorted(ref_t, q)
        best, bd = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(ref_t) and abs(ref_t[jj] - q) <= bd:
                best, bd = jj, abs(ref_t[jj] - q)
        out[i] = best
    return out


class EurocFrame(NamedTuple):
    timestamp: float
    img_left_path: str
    img_right_path: Optional[str]
    imu_acc: np.ndarray     # (N,3) measurements since previous frame
    imu_gyro: np.ndarray    # (N,3)
    imu_t: np.ndarray       # (N,)


class EurocSequence:
    """Lazy EuRoC sequence reader (mav0 layout)."""

    def __init__(self, root: str, stereo: bool = True,
                 timestamps_file: Optional[str] = None):
        mav = os.path.join(root, "mav0")
        if not os.path.isdir(mav):
            mav = root
        self.cam0_t, self.cam0_files = parse_euroc_cam(
            os.path.join(mav, "cam0", "data.csv"))
        self.cam0_dir = os.path.join(mav, "cam0", "data")
        self.stereo = stereo
        if stereo:
            self.cam1_t, self.cam1_files = parse_euroc_cam(
                os.path.join(mav, "cam1", "data.csv"))
            self.cam1_dir = os.path.join(mav, "cam1", "data")
            self.right_of = associate(self.cam0_t, self.cam1_t, 0.005)
        self.imu_t, self.imu_gyro, self.imu_acc = parse_euroc_imu(
            os.path.join(mav, "imu0", "data.csv"))
        # optional per-sequence timestamp list (reference
        # settings/EuRoC_TimeStamps) restricting the evaluated frames
        if timestamps_file:
            want = np.loadtxt(timestamps_file, dtype=np.int64) * 1e-9
            sel = associate(want, self.cam0_t, 0.005)
            keep = sel[sel >= 0]
            self.cam0_t = self.cam0_t[keep]
            self.cam0_files = [self.cam0_files[i] for i in keep]
            if stereo:
                self.right_of = self.right_of[keep]

    def __len__(self) -> int:
        return len(self.cam0_t)

    def frames(self) -> Iterator[EurocFrame]:
        prev_t = None
        for i, t in enumerate(self.cam0_t):
            if prev_t is None:
                lo = 0
            else:
                lo = int(np.searchsorted(self.imu_t, prev_t, side="right"))
            hi = int(np.searchsorted(self.imu_t, t, side="right"))
            right = None
            if self.stereo and self.right_of[i] >= 0:
                right = os.path.join(self.cam1_dir,
                                     self.cam1_files[self.right_of[i]])
            yield EurocFrame(
                timestamp=float(t),
                img_left_path=os.path.join(self.cam0_dir,
                                           self.cam0_files[i]),
                img_right_path=right,
                imu_acc=self.imu_acc[lo:hi],
                imu_gyro=self.imu_gyro[lo:hi],
                imu_t=self.imu_t[lo:hi],
            )
            prev_t = t


def load_gray(path: str) -> np.ndarray:
    """Load an image as float32 grayscale (0..255); needs OpenCV."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)
