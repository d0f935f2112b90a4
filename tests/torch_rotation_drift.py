#!/usr/bin/env python3
"""How far a stereo session's rotations drift from SO(3).

    python tests/torch_rotation_drift.py port [--device cuda] [--frames 70]
                                              [--no-guard] [--nudge K:AXIS]
    JAX_PLATFORMS=cpu python tests/torch_rotation_drift.py reference
                                              [--guard] [--nudge K:AXIS]

Runs ``chip_smoke.py``'s stereo session (``StereoTracker`` at the
``SlamConfig`` defaults on the stereo e2e sequence) with the port on the
given device, or with the JAX package on the CPU, and prints per frame the
state, the inlier count, the keyframe count, the live pose's distance from
SO(3) (max |R^T R - I|), the largest over the map's keyframes, the live
camera centre's distance from the ground truth, and the background BA's
scatters of that frame (``shift``: the live pose moved by
cur o inv(old) o new; ``adopt``: it took the refined keyframe pose;
``still``: the chunk accepted no step); at the end the metric ATE of the
resolved trajectory.

``--no-guard`` turns off the port's re-orthonormalization
(``engine/tracker.py::keep_on_so3``); ``--guard`` applies the same step
to the JAX package's shift, in this process only. ``--nudge K:AXIS``
moves the live translation's AXIS entry by one float32 ulp after frame K,
a rounding-sized difference (ROADMAP C6). The port mode imports no JAX.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _drift(R) -> float:
    R = np.asarray(_host(R), np.float64)
    return float(np.abs(np.swapaxes(R, -1, -2) @ R - np.eye(3)).max())


def _count_scatters(cls, counts, guard=None):
    """Wrap ``cls._scatter_lba`` to count its outcomes into ``counts``;
    ``guard`` (a pose -> pose function) is applied after a shift."""
    scatter = cls._scatter_lba

    def counted(self, p, final):
        moved = scatter(self, p, final)
        if not moved:
            counts["still"] += 1
            return moved
        k = p.newest_kf
        if np.array_equal(_host(self.cur_pose.R), _host(self.map.kf_pose.R[k])):
            counts["adopt"] += 1
        else:
            counts["shift"] += 1
            if guard is not None:
                self.cur_pose = guard(self.cur_pose)
        return moved

    cls._scatter_lba = counted


def _reference_guard():
    """The port's keep_on_so3 on the JAX package's types."""
    import jax.numpy as jnp
    from orb_slam_fusion_tpu import lie
    from orb_slam_fusion_tpu_torch.engine.tracker import ROTATION_DRIFT_TOL

    def guard(T):
        if _drift(T.R) <= ROTATION_DRIFT_TOL:
            return T
        return lie.SE3(lie.so3_normalize(jnp.asarray(T.R)), T.t)
    return guard


def run(mode: str, device: str, frames: int, guard: bool, nudge):
    cfg_kw = dict(loop_closing=False)
    r = dict(chip_smoke.STEREO_RENDER)
    nf = r.pop("n_features")
    base = chip_smoke.STEREO_BASELINE
    counts = dict(shift=0, adopt=0, still=0)
    if mode == "port":
        import torch
        from orb_slam_fusion_tpu_torch import sim
        from orb_slam_fusion_tpu_torch.engine import SlamConfig
        from orb_slam_fusion_tpu_torch.engine import tracker as tmod
        from orb_slam_fusion_tpu_torch.engine.stereo_tracker import (
            StereoTracker)
        from orb_slam_fusion_tpu_torch.io import ate_rmse

        if device == "cuda":
            from orb_slam_fusion_tpu_torch.kernels import build
            build.build_all()
        if not guard:
            tmod.keep_on_so3 = lambda T: T
        _count_scatters(tmod.MonoTracker, counts)
        dev = torch.device(device)
        cfg = SlamConfig(**cfg_kw)
        tr = StereoTracker(cfg, baseline=base, device=dev)

        def step(world, k):
            pair = sim.render_stereo_frame(world, k, cfg.cam_params,
                                           cfg.image_size, nf, base,
                                           device=dev, **r)
            return tr.process_stereo_features(*pair,
                                              float(world.timestamps[k]))

        def as_t(t):
            return torch.from_numpy(t).to(dev)
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        from orb_slam_fusion_tpu import sim
        from orb_slam_fusion_tpu.engine import SlamConfig
        from orb_slam_fusion_tpu.engine import tracker as tmod
        from orb_slam_fusion_tpu.engine.stereo_tracker import StereoTracker
        from orb_slam_fusion_tpu.io import ate_rmse

        _count_scatters(tmod.MonoTracker, counts,
                        _reference_guard() if guard else None)
        cfg = SlamConfig(**cfg_kw)
        tr = StereoTracker(cfg, baseline=base)

        def step(world, k):
            fL, fR = sim.render_stereo_frame(
                world, k, jnp.asarray(cfg.cam_params), cfg.image_size, nf,
                base, **r)
            return tr.process_stereo_features(fL, fR,
                                              float(world.timestamps[k]))

        as_t = jnp.asarray

    world = sim.make_corridor_world(**chip_smoke.STEREO_WORLD)
    gt = sim.gt_positions(world)
    for k in range(frames):
        for key in counts:
            counts[key] = 0
        rec = step(world, k)
        if nudge is not None and k == nudge[0]:
            t = np.array(_host(tr.cur_pose.t), np.float32)
            t[nudge[1]] = np.nextafter(t[nudge[1]], np.float32(np.inf))
            tr.cur_pose = tr.cur_pose._replace(t=as_t(t))
        n = int(tr.map.n_kf)
        R, t = (np.asarray(_host(x), np.float64)
                for x in (rec.pose.R, rec.pose.t))
        centre = np.linalg.norm(-R.T @ t - gt[k])
        print(f"{k:3d} {rec.state:10s} {int(rec.tracked):4d} kf {n:3d} "
              f"live {_drift(R):.3e} keyframes "
              f"{_drift(tr.map.kf_pose.R[:n]):.3e} centre error "
              f"{centre:.4f} m  shift {counts['shift']} adopt "
              f"{counts['adopt']} still {counts['still']}", flush=True)
    traj = tr.trajectory_tum()
    ate = ate_rmse(traj[:, 1:4], gt[:len(traj)], with_scale=False)
    print(f"metric ATE {float(ate):.6f} m")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["port", "reference"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int,
                    default=chip_smoke.STEREO_WORLD["n_frames"])
    ap.add_argument("--no-guard", action="store_true",
                    help="port: turn the re-orthonormalization off")
    ap.add_argument("--guard", action="store_true",
                    help="reference: apply the port's re-orthonormalization")
    ap.add_argument("--nudge", default=None,
                    help="K:AXIS, one ulp on the live translation after "
                         "frame K")
    a = ap.parse_args()
    nudge = tuple(int(v) for v in a.nudge.split(":")) if a.nudge else None
    guard = not a.no_guard if a.mode == "port" else a.guard
    run(a.mode, a.device, a.frames, guard, nudge)


if __name__ == "__main__":
    main()
