#!/usr/bin/env python3
"""How far float32 rounding alone moves the monocular session, on the CPU.

The session ``chip_smoke.py`` gates (``SlamConfig(loop_closing=False)``
defaults, the tracker e2e sequence at 1024 features; settings from
``tests/torch_goldens/mono_session_480x752.json``) run four ways:

    python tests/torch_session_spread.py port --threads 1 3 8
    JAX_PLATFORMS=cpu python tests/torch_session_spread.py reference \
        [--xla-flags=--xla_cpu_enable_fast_math=true]
    JAX_PLATFORMS=cpu python tests/torch_session_spread.py carry \
        --at 10 24 30 44 50 70
    JAX_PLATFORMS=cpu python tests/torch_session_spread.py compare \
        --e2e --threads 2

``port``: the port on the CPU at each torch thread count (each count
rounds its sums differently); prints per run the tracked frames, keyframes,
map points, the ATE after init and the trajectory's RMS distance from the
golden's (both similarity-aligned to the ground truth). ``reference``: the
JAX package under the given XLA flags, the same readings. With
``--perturb-seeds``, ``port`` and ``reference`` run once per seed with
the map's point and keyframe positions scaled by 1 + 1e-5 N(0, 1) just
after initialization (the size of the port's own difference from the
reference there), the same draws in both packages: how far the session's
outcome spreads under perturbations of that size. ``carry``: loads
the reference's state at each listed frame into the port (a background BA
in flight drained first, on a copy) and steps both three frames, printing
each step's state, inliers, keyframes and map points side by side.
``compare``: both sessions free-running, frame by frame; prints per frame
both sessions' state, inliers, keyframes, map points and the largest
difference of the live camera translations, then the first frame whose
state or inlier count differs and how many do (``--e2e``: the
``tests/test_torch_session.py`` configuration, 512 features, instead;
``--sync-ba``: both with ``background_lba=False``).
All but ``port`` need JAX.

``--image`` (before the mode) runs the image session instead
(``process_image`` over the 50 rendered 240x376 frames of
``tests/torch_goldens/image_session_240x376.json``):

    JAX_PLATFORMS=cpu python tests/torch_session_spread.py --image \
        reference --xla-flags=--xla_cpu_enable_fast_math=true
"""

import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

GOLDEN = os.path.join(HERE, "torch_goldens", "mono_session_480x752.json")
IMAGE_GOLDEN = os.path.join(HERE, "torch_goldens",
                            "image_session_240x376.json")
IMAGE = False        # set by --image
# the perturbation's relative size: the port's own difference from the
# reference just after init (1.5e-5 m in the live camera position)
PERTURB_REL = 1e-5


def _golden():
    with open(IMAGE_GOLDEN if IMAGE else GOLDEN) as fh:
        return json.load(fh)


def _config(golden, config_cls, orb_cls):
    c = dict(golden["config"])
    if "n_features" in c:
        c["orb"] = orb_cls(n_features=c.pop("n_features"))
    for k in ("cam_params", "image_size"):
        if k in c:
            c[k] = tuple(c[k])
    return config_cls(**c)


def _world(sim, golden):
    if IMAGE:
        from chip_smoke import _gentle_positions
        w = golden["world"]
        return sim.world_from_trajectory(_gentle_positions(w["n_frames"]),
                                         n_points=w["n_points"],
                                         seed=w["seed"])
    return sim.make_corridor_world(**golden["world"])


def _port_session(golden, cfg=None):
    """(config, world, step(tracker, k) -> record) for the port on the
    CPU."""
    from orb_slam_fusion_tpu_torch import sim
    from orb_slam_fusion_tpu_torch.engine import SlamConfig
    from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams

    cfg = cfg or _config(golden, SlamConfig, OrbParams)
    world = _world(sim, golden)
    ts = lambda k: float(world.timestamps[k])            # noqa: E731
    if IMAGE:
        return cfg, world, lambda tr, k: tr.process_image(
            sim.render_image(world, k, cfg.cam_params, cfg.image_size),
            ts(k))
    nf, r = _render_kw(golden)
    return cfg, world, lambda tr, k: tr.process_features(
        sim.render_frame(world, k, cfg.cam_params, cfg.image_size, nf,
                         device="cpu", **r), ts(k))


def _readings(label, traj, states, gt, golden):
    from orb_slam_fusion_tpu_torch.io import align_horn, ate_rmse

    start = states.index("init-done")
    est = np.asarray(traj)[start:, 1:4]
    g = gt[start:len(traj)]

    def aligned(e):
        s, R, t = align_horn(e, g)
        return (s * (R @ np.asarray(e, np.float64).T)).T + t

    ref = np.asarray(golden["trajectory_tum"])[start:len(traj), 1:4]
    d = aligned(est) - aligned(ref)
    # how fast the run leaves the golden's: the first frame whose camera
    # position (unaligned) lies more than 1e-4, 1e-3, 1e-2 m from it
    dev = np.abs(np.asarray(traj)[:, 1:4] - np.asarray(
        golden["trajectory_tum"])[:len(traj), 1:4]).max(axis=1)
    print(json.dumps(dict(
        run=label, init_frame=start,
        tracked=sum(s in ("ok", "init-done") for s in states),
        ate_m=float(ate_rmse(est, g)),
        trajectory_rms_vs_golden_m=float(np.sqrt((d ** 2).sum(1).mean())),
        first_frame_off_golden_by={f"{th:g}": next(
            (k for k, v in enumerate(dev) if v > th), None)
            for th in (1e-4, 1e-3, 1e-2)})), flush=True)


def _render_kw(golden):
    r = dict(golden["render"])
    return r.pop("n_features"), r


def _perturbed(tr, seed, as_array):
    """``tr``'s map with its point and keyframe positions scaled by
    1 + PERTURB_REL * N(0, 1), drawn from ``seed``; ``as_array`` turns
    numpy into the tracker's array type."""
    rng = np.random.RandomState(seed)
    m = tr.map

    def scaled(a):
        a = np.asarray(a)
        return as_array((a * (1 + PERTURB_REL
                               * rng.standard_normal(a.shape)))
                        .astype(a.dtype))
    return m._replace(mp_pos=scaled(m.mp_pos),
                      kf_pose=m.kf_pose._replace(t=scaled(m.kf_pose.t)))


def _session_readings(label, golden, gt, new_tracker, step, seed,
                      as_array):
    tr = new_tracker()
    states = []
    for k in range(golden["world"]["n_frames"]):
        states.append(step(tr, k).state)
        if seed is not None and states[-1] == "init-done":
            tr.map = _perturbed(tr, seed, as_array)
    if seed is not None:
        label += f", perturbed after init (seed {seed})"
    print(f"{label}: n_kf {int(tr.map.n_kf)}, n_mp {int(tr.map.n_mp)}",
          flush=True)
    _readings(label, tr.trajectory_tum(), states, gt, golden)


def run_port(threads, perturb_seeds):
    import torch
    from orb_slam_fusion_tpu_torch import sim
    from orb_slam_fusion_tpu_torch.engine import MonoTracker

    golden = _golden()
    cfg, world, step = _port_session(golden)
    gt = sim.gt_positions(world)
    for n in threads:
        torch.set_num_threads(n)
        for seed in perturb_seeds or [None]:
            _session_readings(
                f"port, {n} torch threads", golden, gt,
                lambda: MonoTracker(cfg, device="cpu"), step, seed,
                torch.from_numpy)


def _reference_session(golden):
    """(config, tracker, step(tracker, k) -> record) for the JAX package
    on the CPU."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    import jax.numpy as jnp
    from orb_slam_fusion_tpu import sim as jsim
    from orb_slam_fusion_tpu.engine import MonoTracker, SlamConfig
    from orb_slam_fusion_tpu.frontend.extractor import OrbParams

    cfg = _config(golden, SlamConfig, OrbParams)
    world = _world(jsim, golden)
    cam = jnp.asarray(cfg.cam_params, jnp.float32)
    ts = lambda k: float(world.timestamps[k])            # noqa: E731
    if IMAGE:
        return cfg, MonoTracker(cfg), lambda tr, k: tr.process_image(
            jnp.asarray(jsim.render_image(world, k, cam, cfg.image_size)),
            ts(k))
    nf, r = _render_kw(golden)
    return cfg, MonoTracker(cfg), lambda tr, k: tr.process_features(
        jsim.render_frame(world, k, cam, cfg.image_size, nf, **r), ts(k))


def run_reference(perturb_seeds):
    import jax.numpy as jnp
    from orb_slam_fusion_tpu_torch import sim

    golden = _golden()
    gt = sim.gt_positions(_world(sim, golden))
    for seed in perturb_seeds or [None]:
        _, tr, step = _reference_session(golden)
        _session_readings(
            f"reference, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
            golden, gt, lambda: tr, step, seed, jnp.asarray)


def run_carry(frames):
    import torch
    import test_torch_helpers as h
    from orb_slam_fusion_tpu_torch.engine import MonoTracker
    from orb_slam_fusion_tpu_torch.map import convert

    golden = _golden()
    _, jt, jstep = _reference_session(golden)
    cfg, _, tstep = _port_session(golden)
    torch.set_num_threads(4)
    for k in range(max(frames) + 1):
        if k in frames:
            ref = copy.deepcopy(jt)
            tt = MonoTracker(cfg, device="cpu")
            convert.tracker_state_from_numpy(tt, h.jax_tracker_state(ref))
            for kk in range(k, min(k + 3, golden["world"]["n_frames"])):
                rj, rt = jstep(ref, kk), tstep(tt, kk)
                a = [rj.state, int(rj.tracked), int(ref.map.n_kf),
                     int(ref.map.n_mp)]
                b = [rt.state, int(rt.tracked), int(tt.map.n_kf),
                     int(tt.map.n_mp)]
                print(json.dumps(dict(carried_at=k, frame=kk, reference=a,
                                      port=b, same=a == b)), flush=True)
        jstep(jt, k)


E2E = dict(config=dict(cam_params=(400.0, 400.0, 376.0, 240.0),
                       image_size=(480, 752), max_keyframes=64,
                       max_map_points=4096, ba_window=6, loop_closing=False),
           n_features=512)


def run_compare(e2e, threads, sync_ba):
    import torch

    golden = _golden()
    if e2e:
        golden["config"] = dict(E2E["config"], n_features=E2E["n_features"])
        golden["render"]["n_features"] = E2E["n_features"]
    if sync_ba:
        golden["config"]["background_lba"] = False
    from orb_slam_fusion_tpu_torch.engine import MonoTracker
    _, jt, jstep = _reference_session(golden)
    tcfg, _, tstep = _port_session(golden)
    torch.set_num_threads(threads)
    tt = MonoTracker(tcfg, device="cpu")
    differ, tracked = [], [0, 0]
    for k in range(golden["world"]["n_frames"]):
        rj, rt = jstep(jt, k), tstep(tt, k)
        for i, r in enumerate((rj, rt)):
            tracked[i] += r.state in ("ok", "init-done")
        a = [rj.state, int(rj.tracked), int(jt.map.n_kf), int(jt.map.n_mp)]
        b = [rt.state, int(rt.tracked), int(tt.map.n_kf), int(tt.map.n_mp)]
        if a[:2] != b[:2]:
            differ.append(k)
        dt = float(np.abs(np.asarray(jt.cur_pose.t)
                          - tt.cur_pose.t.numpy()).max())
        print(json.dumps(dict(frame=k, reference=a, port=b,
                              pose_t_max_abs_diff=dt)), flush=True)
    print(json.dumps(dict(
        config=("e2e 512 features" if e2e else "golden's")
        + (", synchronous local BA" if sync_ba else ""),
        torch_threads=threads, first_differing_frame=differ[0] if differ
        else None, frames_differing=len(differ),
        tracked=tracked,
        n_kf=[int(jt.map.n_kf), int(tt.map.n_kf)],
        n_mp=[int(jt.map.n_mp), int(tt.map.n_mp)])), flush=True)


def main():
    global IMAGE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", action="store_true")
    sub = ap.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("port")
    p.add_argument("--threads", type=int, nargs="+", default=[1])
    q = sub.add_parser("reference")
    q.add_argument("--xla-flags", default="")
    for x in (p, q):
        x.add_argument("--perturb-seeds", type=int, nargs="*", default=[])
    c = sub.add_parser("carry")
    c.add_argument("--at", type=int, nargs="+", default=[10, 30, 50, 70])
    d = sub.add_parser("compare")
    d.add_argument("--e2e", action="store_true")
    d.add_argument("--threads", type=int, default=2)
    d.add_argument("--sync-ba", action="store_true",
                   help="both sessions with background_lba=False")
    a = ap.parse_args()
    IMAGE = a.image
    if IMAGE and a.mode == "compare" and a.e2e:
        ap.error("--e2e is a feature session")
    if a.mode == "port":
        run_port(a.threads, a.perturb_seeds)
    elif a.mode == "reference":
        if a.xla_flags:
            os.environ["XLA_FLAGS"] = a.xla_flags
        run_reference(a.perturb_seeds)
    elif a.mode == "carry":
        run_carry(a.at)
    else:
        run_compare(a.e2e, a.threads, a.sync_ba)


if __name__ == "__main__":
    main()
