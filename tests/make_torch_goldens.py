#!/usr/bin/env python3
"""Write the golden runs ``chip_smoke.py`` holds the port's sessions to.

    JAX_PLATFORMS=cpu python tests/make_torch_goldens.py [name ...]

Runs the JAX package's trackers (``loop_closing=False``) on the CPU over
the sessions ``chip_smoke.py`` drives (all, or the named ones), and
writes, per session, a JSON file under ``tests/torch_goldens/``: the
configuration, world and render arguments, and per frame the state, the
inlier count, ``n_kf``, ``n_mp`` and a SHA-256 of the frame's inputs (the
feature arrays, the image, or both feature sets of a pair, with the
RGB-D depths), then the tracked count, the ATE after init (with scale
alignment for the monocular sessions, without for the metric ones, as
their e2e tests measure it) and the estimated trajectory (TUM rows).
The port's own ``sim.py`` regenerates the same inputs bit for bit,
which the input hashes let a run on another machine check.

* ``mono_session_480x752.json``: the tracker e2e sequence (corridor world,
  80 frames, seed 3) at ``SlamConfig``'s default widths (480x752, 1024
  features, 8192 map points, 256 keyframe slots, ``ba_window`` 8).
* ``image_session_240x376.json``: the image e2e sequence (gentle world,
  50 rendered 240x376 images through ``process_image``).
* ``stereo_session_480x752.json``: ``StereoTracker`` (baseline 0.11 m) on
  the stereo e2e sequence (corridor world, 70 frames, seed 7) at
  ``SlamConfig``'s default widths.
* ``stereo_e2e_session_480x752.json``: the same at the stereo e2e test's
  widths (512 features, 6144 map points), which the CPU tests hold the
  port's free-running session to.
* ``rgbd_session_480x752.json``, ``fisheye_mono_session_512x512.json``,
  ``fisheye_stereo_session_512x512.json``: ``RgbdTracker``, the
  Kannala-Brandt ``MonoTracker`` and ``FisheyeStereoTracker`` on the
  sequences of ``test_rgbd_e2e.py`` and ``test_fisheye_e2e.py`` at those
  tests' widths (512 features, 6144 map points).
* ``stereo_vio_session_480x752.json``: ``StereoVioTracker`` (baseline
  0.11 m, ``make_calib()``) at ``SlamConfig``'s default widths on the
  stereo-inertial e2e sequence (``make_vio_sequence``, 160 frames, seed
  4), per frame also the IMU stage and bias; it also writes
  ``stereo_vio_solver_calls.npz``, the arguments and results of the
  ``inertial_init`` and ``visual_inertial_ba`` calls of the IMU-init
  keyframe and of the first VIBA1 keyframe (``tests/test_torch_vi_ba.py``).
* ``stereo_vio_e2e_session_480x752.json``: the same at the e2e test's
  widths (512 features, 96 keyframe slots) over 80 frames, which the CPU
  tests hold the port's free-running session to.
* ``vio_staged_session_480x752.json``: ``VioTracker`` on the sequence and
  at the widths of ``test_staged_imu_init.py`` (180 frames at 10 fps, so
  all three IMU stages fire).
* ``fisheye_image_session_512x512.json``: the Kannala-Brandt
  ``MonoTracker`` through ``process_image`` on the first frames of the
  fisheye mono sequence, rendered as 512x512 images (no frame
  initializes: the record is the two-view initialization's states and
  match counts).

Needs JAX. The settings are ``chip_smoke.py``'s own;
``tests/test_torch_goldens.py`` checks that the committed files still carry
them.
"""

import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from orb_slam_fusion_tpu import cameras, lie, sim  # noqa: E402
from orb_slam_fusion_tpu.engine import MonoTracker, SlamConfig  # noqa: E402
from orb_slam_fusion_tpu.engine.stereo_tracker import (  # noqa: E402
    FisheyeStereoTracker, RgbdTracker, StereoTracker)
from orb_slam_fusion_tpu.frontend.extractor import OrbParams  # noqa: E402
from orb_slam_fusion_tpu.io import ate_rmse  # noqa: E402

OUT = os.path.join(HERE, "torch_goldens")

# the sessions exactly as chip_smoke.py runs them
MONO = dict(config=dict(loop_closing=False), world=chip_smoke.SESSION_WORLD,
            render=chip_smoke.SESSION_RENDER)
IMAGE = dict(config=json.loads(json.dumps(chip_smoke.IMAGE_CONFIG)),
             world=chip_smoke.IMAGE_WORLD)
STEREO = dict(config=dict(loop_closing=False), world=chip_smoke.STEREO_WORLD,
              render=chip_smoke.STEREO_RENDER,
              baseline=chip_smoke.STEREO_BASELINE)
# the same sequence at the e2e test's widths, for the CPU tests'
# free-running comparison (tests/test_torch_stereo_session.py)
STEREO_E2E = dict(STEREO, config=json.loads(json.dumps(chip_smoke.E2E_CONFIG)),
                  render=dict(chip_smoke.STEREO_RENDER, n_features=512))
RGBD = dict(config=json.loads(json.dumps(chip_smoke.E2E_CONFIG)),
            world=chip_smoke.RGBD_WORLD, render=chip_smoke.RGBD_RENDER,
            baseline=chip_smoke.RGBD_BASELINE,
            depth_seed=chip_smoke.RGBD_DEPTH_SEED)
FISHEYE_MONO = dict(config=json.loads(json.dumps(chip_smoke.FISHEYE_CONFIG)),
                    world=chip_smoke.FISHEYE_MONO_WORLD,
                    render=chip_smoke.FISHEYE_MONO_RENDER)
FISHEYE_STEREO = dict(
    config=json.loads(json.dumps(chip_smoke.FISHEYE_CONFIG)),
    world=chip_smoke.FISHEYE_STEREO_WORLD,
    render=chip_smoke.FISHEYE_STEREO_RENDER,
    T_c1_c2=json.loads(json.dumps(chip_smoke.T_C1_C2)))
FISHEYE_IMAGE = dict(config=FISHEYE_MONO["config"],
                     world=chip_smoke.FISHEYE_MONO_WORLD,
                     n_frames=chip_smoke.FISHEYE_IMAGE_FRAMES)


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def finish(tr, world, frames, extra, with_scale=True):
    states = [f["state"] for f in frames]
    start = states.index("init-done") if "init-done" in states else None
    traj = tr.trajectory_tum()
    ate = None
    if start is not None:
        ate = float(ate_rmse(traj[start:, 1:4],
                             sim.gt_positions(world)[start:len(traj)],
                             with_scale=with_scale))
    return dict(extra, frames=frames, init_frame=start,
                trajectory_tum=[[float(v) for v in row] for row in traj],
                tracked=sum(s in ("ok", "init-done") for s in states),
                n_kf=int(tr.map.n_kf), n_mp=int(tr.map.n_mp), ate_m=ate,
                jax_version=jax.__version__,
                generated_by="tests/make_torch_goldens.py")


def record(tr, rec, digest):
    return dict(state=rec.state, tracked=int(rec.tracked),
                n_kf=int(tr.map.n_kf), n_mp=int(tr.map.n_mp),
                inputs_sha256=digest)


def mono_session():
    cfg = SlamConfig(**MONO["config"])
    world = sim.make_corridor_world(**MONO["world"])
    tr = MonoTracker(cfg)
    cam = jnp.asarray(cfg.cam_params)
    r = dict(MONO["render"])
    nf = r.pop("n_features")
    frames = []
    for k in range(MONO["world"]["n_frames"]):
        f = sim.render_frame(world, k, cam, cfg.image_size, nf, **r)
        rec = tr.process_features(f, float(world.timestamps[k]))
        frames.append(record(tr, rec, sha(*(np.asarray(getattr(f, n))
                                            for n in f._fields))))
        print("mono", k, frames[-1]["state"], frames[-1]["tracked"],
              flush=True)
    return finish(tr, world, frames, MONO)


def image_session():
    c = dict(IMAGE["config"])
    cfg = SlamConfig(cam_params=tuple(c.pop("cam_params")),
                     image_size=tuple(c.pop("image_size")),
                     orb=OrbParams(n_features=c.pop("n_features")), **c)
    T = IMAGE["world"]["n_frames"]
    world = sim.world_from_trajectory(
        chip_smoke._gentle_positions(T), n_points=IMAGE["world"]["n_points"],
        seed=IMAGE["world"]["seed"])
    tr = MonoTracker(cfg)
    cam = jnp.asarray(cfg.cam_params, jnp.float32)
    frames = []
    for k in range(T):
        img = sim.render_image(world, k, cam, cfg.image_size)
        rec = tr.process_image(jnp.asarray(img), float(world.timestamps[k]))
        frames.append(record(tr, rec, sha(img)))
        print("image", k, frames[-1]["state"], frames[-1]["tracked"],
              flush=True)
    return finish(tr, world, frames, IMAGE)


def config_of(c):
    """A reference SlamConfig from a JSON-shaped config dict."""
    c = dict(c)
    for k in ("cam_params", "image_size"):
        if k in c:
            c[k] = tuple(c[k])
    if "n_features" in c:
        c["orb"] = OrbParams(n_features=c.pop("n_features"))
    return SlamConfig(**c)


def feats_sha(*fs):
    return sha(*(np.asarray(getattr(f, n)) for f in fs for n in f._fields))


def stereo_session(spec=STEREO):
    cfg = config_of(spec["config"])
    world = sim.make_corridor_world(**spec["world"])
    tr = StereoTracker(cfg, baseline=spec["baseline"])
    cam = jnp.asarray(cfg.cam_params)
    r = dict(spec["render"])
    nf = r.pop("n_features")
    frames = []
    for k in range(spec["world"]["n_frames"]):
        fL, fR = sim.render_stereo_frame(world, k, cam, cfg.image_size, nf,
                                         spec["baseline"], **r)
        rec = tr.process_stereo_features(fL, fR, float(world.timestamps[k]))
        frames.append(record(tr, rec, feats_sha(fL, fR)))
        print("stereo", k, frames[-1]["state"], frames[-1]["tracked"],
              flush=True)
    return finish(tr, world, frames, spec, with_scale=False)


def rgbd_depth(world, k, feats, rng, cam):
    """The RGB-D e2e test's per-feature depth: the nearest projected world
    point's depth with 0.5% noise, -1 beyond 3 px."""
    pose = lie.SE3(world.poses.R[k], world.poses.t[k])
    pc = np.asarray(lie.se3_apply(pose, jnp.asarray(world.points)))
    uvw = np.asarray(cameras.pinhole_project(cam, jnp.asarray(pc)))
    fuv = np.asarray(feats.uv)
    d2 = ((fuv[:, None, :] - uvw[None, :, :]) ** 2).sum(-1)
    d2[:, pc[:, 2] < 0.1] = 1e12
    nearest = d2.argmin(axis=1)
    depth = pc[nearest, 2] * (1.0 + rng.randn(len(nearest)) * 0.005)
    depth = np.where(d2[np.arange(len(nearest)), nearest] < 9.0, depth, -1.0)
    return np.asarray(depth, np.float32)


def rgbd_session():
    cfg = config_of(RGBD["config"])
    world = sim.make_corridor_world(**RGBD["world"])
    tr = RgbdTracker(cfg, baseline=RGBD["baseline"])
    cam = jnp.asarray(cfg.cam_params)
    r = dict(RGBD["render"])
    nf = r.pop("n_features")
    rng = np.random.RandomState(RGBD["depth_seed"])
    frames = []
    for k in range(RGBD["world"]["n_frames"]):
        f = sim.render_frame(world, k, cam, cfg.image_size, nf, **r)
        depth = rgbd_depth(world, k, f, rng, cam)
        rec = tr.process_rgbd_features(f, jnp.asarray(depth),
                                       float(world.timestamps[k]))
        frames.append(record(tr, rec, sha(*(np.asarray(getattr(f, n))
                                            for n in f._fields), depth)))
        print("rgbd", k, frames[-1]["state"], frames[-1]["tracked"],
              flush=True)
    return finish(tr, world, frames, RGBD, with_scale=False)


def fisheye_mono_session():
    cfg = config_of(FISHEYE_MONO["config"])
    world = sim.make_corridor_world(**FISHEYE_MONO["world"])
    tr = MonoTracker(cfg)
    cam = jnp.asarray(cfg.cam_params)
    r = dict(FISHEYE_MONO["render"])
    nf = r.pop("n_features")
    frames = []
    for k in range(FISHEYE_MONO["world"]["n_frames"]):
        f = sim.render_frame(world, k, cam, cfg.image_size, nf,
                             cam_model=cameras.KANNALA_BRANDT8, **r)
        rec = tr.process_features(f, float(world.timestamps[k]))
        frames.append(record(tr, rec, feats_sha(f)))
        print("fisheye mono", k, frames[-1]["state"], frames[-1]["tracked"],
              flush=True)
    return finish(tr, world, frames, FISHEYE_MONO)


def fisheye_stereo_session():
    cfg = config_of(FISHEYE_STEREO["config"])
    world = sim.make_corridor_world(**FISHEYE_STEREO["world"])
    T12 = np.asarray(FISHEYE_STEREO["T_c1_c2"])
    tr = FisheyeStereoTracker(cfg, cfg.cam_params, T12)
    r = dict(FISHEYE_STEREO["render"])
    nf = r.pop("n_features")
    frames = []
    for k in range(FISHEYE_STEREO["world"]["n_frames"]):
        fL, fR = sim.render_fisheye_stereo_frame(
            world, k, cfg.cam_params, cfg.cam_params, cfg.image_size, nf,
            T12, **r)
        rec = tr.process_stereo_features(fL, fR, float(world.timestamps[k]))
        frames.append(record(tr, rec, feats_sha(fL, fR)))
        print("fisheye stereo", k, frames[-1]["state"],
              frames[-1]["tracked"], flush=True)
    return finish(tr, world, frames, FISHEYE_STEREO, with_scale=False)


def fisheye_image_session():
    cfg = config_of(FISHEYE_IMAGE["config"])
    world = sim.make_corridor_world(**FISHEYE_IMAGE["world"])
    tr = MonoTracker(cfg)
    cam = jnp.asarray(cfg.cam_params)
    frames = []
    for k in range(FISHEYE_IMAGE["n_frames"]):
        img = sim.render_image(world, k, cam, cfg.image_size,
                               cam_model=cameras.KANNALA_BRANDT8)
        rec = tr.process_image(jnp.asarray(img), float(world.timestamps[k]))
        frames.append(record(tr, rec, sha(img)))
        print("fisheye image", k, frames[-1]["state"],
              frames[-1]["tracked"], flush=True)
    return finish(tr, world, frames, FISHEYE_IMAGE)


STEREO_VIO = dict(config=dict(loop_closing=False), seq=chip_smoke.VIO_SEQ,
                  render=chip_smoke.VIO_RENDER,
                  baseline=chip_smoke.VIO_BASELINE)
STEREO_VIO_E2E = dict(
    STEREO_VIO, config=json.loads(json.dumps(chip_smoke.VIO_E2E_CONFIG)),
    seq=chip_smoke.VIO_E2E_SEQ,
    render=dict(chip_smoke.VIO_RENDER, n_features=512))
VIO_STAGED = dict(config=json.loads(json.dumps(chip_smoke.STAGED_CONFIG)),
                  seq=chip_smoke.STAGED_SEQ, render=chip_smoke.STAGED_RENDER)
# the solver calls captured from stereo_vio_session for
# tests/test_torch_vi_ba.py: those of the IMU-init keyframe and of the
# first VIBA1 keyframe
VIO_SNAPSHOT = os.path.join(OUT, "stereo_vio_solver_calls.npz")


def vio_record(tr, rec, digest):
    out = record(tr, rec, digest)
    out.update(imu_initialized=bool(tr.imu_initialized),
               imu_stage=int(tr._imu_stage),
               bias=[float(v) for v in np.concatenate(
                   [np.asarray(tr.bias.gyro), np.asarray(tr.bias.acc)])])
    return out


def _flat(prefix, x, out):
    """Flatten a pytree of arrays (NamedTuples, tuples) into npz keys."""
    if x is None:
        return
    if hasattr(x, "_fields"):
        for f in x._fields:
            _flat(f"{prefix}.{f}", getattr(x, f), out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _flat(f"{prefix}.{i}", v, out)
    else:
        out[prefix] = np.asarray(x)


class _Capture:
    """Records the reference tracker's inertial_init / visual_inertial_ba
    calls (arguments and results) made during one frame."""

    def __init__(self):
        import orb_slam_fusion_tpu.engine.vio_tracker as vt
        self.vt, self.calls = vt, []
        self.orig = (vt.inertial_init, vt.visual_inertial_ba)

        def wrap(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                self.calls.append((name, args, kw, out))
                return out
            return call
        vt.inertial_init = wrap("inertial_init", self.orig[0])
        vt.visual_inertial_ba = wrap("visual_inertial_ba", self.orig[1])

    def close(self):
        self.vt.inertial_init, self.vt.visual_inertial_ba = self.orig


def _snapshot(calls, tag, out):
    for n, (name, args, kw, res) in enumerate(calls):
        key = f"{tag}.{n}.{name}"
        if name == "inertial_init":
            poses, ifac, calib = args
            _flat(f"{key}.poses", poses, out)
            _flat(f"{key}.ifac", ifac, out)
            _flat(f"{key}.calib", calib, out)
            for k in ("optimize_scale", "prior_g", "prior_a"):
                out[f"{key}.kw.{k}"] = np.asarray(kw[k])
            _flat(f"{key}.out", res, out)
        else:
            state, prob, ifac, calib = args
            _flat(f"{key}.state", state, out)
            prob = prob._replace(lm_factor_idx=None, lm_factor_valid=None)
            _flat(f"{key}.prob", prob, out)
            _flat(f"{key}.ifac", ifac, out)
            _flat(f"{key}.calib", calib, out)
            out[f"{key}.kw.fixed_pose"] = np.asarray(kw["fixed_pose"])
            out[f"{key}.kw.fixed_inertial"] = np.asarray(kw["fixed_inertial"])
            out[f"{key}.kw.iters"] = np.asarray(kw["iters"])
            _flat(f"{key}.out", res, out)


def stereo_vio_session(spec=STEREO_VIO, snapshot=None):
    from orb_slam_fusion_tpu.engine.vio_tracker import StereoVioTracker
    from orb_slam_fusion_tpu.imu.preintegration import make_calib
    cfg = config_of(spec["config"])
    seq = sim.make_vio_sequence(**spec["seq"])
    world = seq.world
    tr = StereoVioTracker(cfg, spec["baseline"], make_calib())
    cam = jnp.asarray(cfg.cam_params)
    r = dict(spec["render"])
    nf = r.pop("n_features")
    cap = _Capture() if snapshot else None
    snaps, frames = {}, []
    try:
        for k in range(spec["seq"]["n_frames"]):
            fL, fR = sim.render_stereo_frame(world, k, cam, cfg.image_size,
                                             nf, spec["baseline"], **r)
            imu = chip_smoke._imu_of(seq, k)
            stage0 = tr._imu_stage
            if cap:
                cap.calls = []
            rec = tr.process_stereo_imu(fL, fR, float(world.timestamps[k]),
                                        *imu)
            frames.append(vio_record(tr, rec, feats_sha(fL, fR)
                                     + sha(*imu)))
            if cap and tr._imu_stage != stage0 and tr._imu_stage <= 2:
                _snapshot(cap.calls, f"stage{tr._imu_stage}", snaps)
                snaps[f"stage{tr._imu_stage}.frame"] = np.asarray(k)
            print("stereo vio", k, frames[-1]["state"],
                  frames[-1]["tracked"], frames[-1]["imu_stage"],
                  flush=True)
    finally:
        if cap:
            cap.close()
    if snapshot:
        np.savez_compressed(snapshot, **snaps)
    return finish(tr, world, frames, spec, with_scale=False)


def vio_staged_session():
    from orb_slam_fusion_tpu.engine.vio_tracker import VioTracker
    from orb_slam_fusion_tpu.imu.preintegration import make_calib
    cfg = config_of(VIO_STAGED["config"])
    seq = sim.make_vio_sequence(**VIO_STAGED["seq"])
    world = seq.world
    tr = VioTracker(cfg, make_calib())
    cam = jnp.asarray(cfg.cam_params)
    r = dict(VIO_STAGED["render"])
    nf = r.pop("n_features")
    frames = []
    for k in range(VIO_STAGED["seq"]["n_frames"]):
        f = sim.render_frame(world, k, cam, cfg.image_size, nf, **r)
        imu = chip_smoke._imu_of(seq, k)
        rec = tr.process_frame_imu(f, float(world.timestamps[k]), *imu)
        frames.append(vio_record(tr, rec, feats_sha(f) + sha(*imu)))
        print("vio staged", k, frames[-1]["state"], frames[-1]["tracked"],
              frames[-1]["imu_stage"], flush=True)
    g = finish(tr, world, frames, VIO_STAGED, with_scale=False)
    # tests/test_staged_imu_init.py's ATE: the second half, metric
    start = len(frames) // 2
    traj = tr.trajectory_tum()
    g["ate_second_half_m"] = float(ate_rmse(
        traj[start:, 1:4], sim.gt_positions(world)[start:len(traj)],
        with_scale=False))
    return g


SESSIONS = {"mono_session_480x752.json": mono_session,
            "image_session_240x376.json": image_session,
            "stereo_session_480x752.json": stereo_session,
            "stereo_e2e_session_480x752.json": (
                lambda: stereo_session(STEREO_E2E)),
            "rgbd_session_480x752.json": rgbd_session,
            "fisheye_mono_session_512x512.json": fisheye_mono_session,
            "fisheye_stereo_session_512x512.json": fisheye_stereo_session,
            "fisheye_image_session_512x512.json": fisheye_image_session,
            "stereo_vio_session_480x752.json": (
                lambda: stereo_vio_session(snapshot=VIO_SNAPSHOT)),
            "stereo_vio_e2e_session_480x752.json": (
                lambda: stereo_vio_session(STEREO_VIO_E2E)),
            "vio_staged_session_480x752.json": vio_staged_session}


def main():
    os.makedirs(OUT, exist_ok=True)
    names = sys.argv[1:] or list(SESSIONS)
    for name, fn in ((n, SESSIONS[n]) for n in names):
        t0 = time.perf_counter()
        g = fn()
        with open(os.path.join(OUT, name), "w") as fh:
            json.dump(g, fh, indent=1)
        print(f"wrote {name}: tracked {g['tracked']}, ATE {g['ate_m']}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
