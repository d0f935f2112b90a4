"""Headless map/frame drawing (reference: MapDrawer/FrameDrawer).

Counterpart of ``orb_slam_fusion_tpu/viz/drawers.py``; matplotlib is
imported inside the functions that draw, so the package imports without
it (the GPU machine has none).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..map import map_state as ms


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def _frustum_lines(R_cw: np.ndarray, t_cw: np.ndarray, scale: float = 0.15):
    """Camera frustum wireframe in world coords (reference
    MapDrawer::DrawKeyFrames geometry)."""
    Rwc = R_cw.T
    C = -Rwc @ t_cw
    w, h, z = 0.8 * scale, 0.5 * scale, scale
    corners = np.array([[w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]])
    pts = [C + Rwc @ c for c in corners]
    lines = []
    for i in range(4):
        lines.append((C, pts[i]))
        lines.append((pts[i], pts[(i + 1) % 4]))
    return lines


def draw_map(m: ms.MapState, path: str,
             trajectory: Optional[np.ndarray] = None,
             covisibility: bool = True,
             title: str = "map") -> None:
    """Render the map to a PNG: points, keyframe frusta, covisibility
    edges, optional full-frame trajectory (reference Viewer content)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    valid = _host(m.mp_valid)
    pts = _host(m.mp_pos)[valid]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1.0, c="#555555", alpha=0.5,
                   label=f"{len(pts)} points")
    n_kf = int(m.n_kf)
    kf_valid = _host(m.kf_valid)
    centers = []
    for k in range(n_kf):
        if not kf_valid[k]:
            centers.append(None)
            continue
        R = _host(m.kf_pose.R[k])
        t = _host(m.kf_pose.t[k])
        C = -R.T @ t
        centers.append(C)
        for a, b in _frustum_lines(R, t):
            ax.plot([a[0], b[0]], [a[2], b[2]], c="#1f77b4", lw=0.5)
    if covisibility and n_kf > 1:
        W = _host(ms.covisibility_matrix(m))
        for i in range(n_kf):
            if centers[i] is None:
                continue
            for j in range(i + 1, n_kf):
                if centers[j] is None or W[i, j] < 30:
                    continue
                a, b = centers[i], centers[j]
                ax.plot([a[0], b[0]], [a[2], b[2]], c="#2ca02c",
                        lw=0.4, alpha=0.5)
    if trajectory is not None and len(trajectory):
        ax.plot(trajectory[:, 0], trajectory[:, 2], c="#d62728", lw=1.0,
                label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(f"{title}: {n_kf} KFs")
    ax.axis("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_frame(img: Optional[np.ndarray], uv: np.ndarray, tracked_mask,
               path: str, state: str = "") -> None:
    """Per-frame overlay: keypoints green if tracked, red otherwise
    (reference FrameDrawer::DrawFrame)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    if img is not None:
        ax.imshow(_host(img), cmap="gray", vmin=0, vmax=255)
    uv = _host(uv)
    tm = _host(tracked_mask)
    ax.scatter(uv[~tm, 0], uv[~tm, 1], s=4, c="red", marker="x")
    ax.scatter(uv[tm, 0], uv[tm, 1], s=5, c="lime", marker="o",
               facecolors="none")
    ax.set_title(f"{state}: {int(tm.sum())} tracked / {len(uv)} kps")
    ax.set_xlim(0, img.shape[1] if img is not None else uv[:, 0].max())
    ax.set_ylim(img.shape[0] if img is not None else uv[:, 1].max(), 0)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


class MapDrawer:
    """Stateful wrapper matching the reference class name."""

    def __init__(self, tracker):
        self.tracker = tracker

    def save(self, path: str) -> None:
        traj = self.tracker.trajectory_tum()
        draw_map(self.tracker.map, path,
                 trajectory=traj[:, 1:4] if len(traj) else None)


class FrameDrawer:
    def __init__(self, tracker):
        self.tracker = tracker
        self._last = None

    def update(self, img, feats, rec) -> None:
        obs = self.tracker._cur_obs
        tracked = (_host(obs) >= 0) if obs is not None else \
            np.zeros(feats.uv.shape[0], bool)
        self._last = (_host(img) if img is not None else None,
                      _host(feats.uv), tracked, rec.state)

    def save(self, path: str) -> None:
        if self._last is None:
            return
        img, uv, tracked, state = self._last
        draw_frame(img, uv, tracked, path, state)
