#!/usr/bin/env python3
"""Write the golden runs ``chip_smoke.py`` holds the port's sessions to.

    JAX_PLATFORMS=cpu python tests/make_torch_goldens.py [name ...]

Runs the JAX package's trackers on the CPU over
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

* ``system_session_480x752.json``: the JAX package's ``System`` built
  from ``chip_smoke.py``'s EuRoC settings file (stereo-inertial, the
  unrectified pinhole rig, 1200 features, loop closing on) over a mav0
  tree of the stereo-inertial sequence, fed raw rendered pairs through
  ``track_stereo_imu`` until 5 frames after its IMU init (at most 80); per
  frame the IMU stage and bias as above, then the autosaved atlas restored
  into a second ``System``: the relocalization on the middle frame and
  localization mode over the next 5 frames.

* ``system_mono_session.json`` and ``system_mono_atlas.npz``: the JAX
  ``System``'s 16-frame monocular feature session of
  ``tests/test_torch_system.py`` (the last 4 frames in localization mode):
  per-frame records and poses, the five trajectory files, the interactive
  viewer and the first line of the debug dump, and its atlas checkpoint.

* The loop-closing slice (``loop_closing=True``): ``loop_map_20kf.npz``
  (``test_loop_closing_e2e.py``'s drifted loop map as the JAX package
  builds it, with its closer's results: the closing keyframe, the loop
  edge, the poses after the correction and after the drained GBA, the
  funnel counters); ``atlas_session_480x752.json``,
  ``reloc_session_480x752.json`` and
  ``stereo_vio_atlas_session_480x752.json`` (``MonoTracker`` and
  ``StereoVioTracker`` at ``SlamConfig()``'s defaults on the sequences of
  ``test_atlas_merge.py``, ``test_relocalization.py`` and
  ``test_inertial_merge.py``; per frame also the archived-map count, the
  database rows and the loops closed); ``loop_session_480x752.json``
  (``tests/test_torch_loop_session.py``'s 60 frames at 256 features).
  The ``*_test_session`` runs at the atlas tests' widths write the
  carried-state snapshots ``atlas_merge_step.pkl.gz``,
  ``reloc_step.pkl.gz`` and ``vio_merge_step.pkl.gz``: the tracker's state
  before the first merge (or relocalization) frame, drained, trimmed to
  its live rows, with the frame's inputs and the reference's state after
  it. The stereo-inertial golden run also writes
  ``vio_loop_closures.pkl.gz``, its state at the ``try_close`` calls that
  close the merged map's third and fourth loops and the closer's result;
  ``loop_closer_steps.pkl.gz`` records the reference closer's every step
  on ``test_loop_closing_e2e.py``'s maps (flat and tree vocabularies, the
  aliased corridor) for ``tests/test_torch_loop_closing.py``.

* The multi-device slice (``mesh_*``; these run the JAX package on its 8
  virtual CPU devices, as ``tests/conftest.py`` sets them up):
  ``mesh_dryrun.npz``, the four cases of ``__graft_entry__.py``'s
  ``dryrun_multichip`` at its shapes (landmark-sharded BA over 64
  keyframes and 8192 landmarks, the drifted 64-node Sim3 loop, VI-BA over
  12 keyframes and 1024 landmarks, map-sharded tracking of M = 2048 map
  points against F = 512 keypoints), inputs and the reference's results;
  ``mesh_session_480x752.json``, ``MonoTracker(SlamConfig(mesh_devices=
  8))`` at the default widths on ``test_mesh_engine.py``'s corridor (60
  frames, render seed 11), for ``chip_smoke.py``'s ``mesh_session``;
  ``mesh_engine_session.json``, the same at ``test_mesh_engine.py``'s own
  configuration, for ``tests/test_torch_mesh_engine.py``;
  ``mesh_gba_20kf.npz``, the closer of ``loop_map_20kf.npz`` with a
  meshed facade tracker: its loop correction and ``_global_ba_dist``.

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
if any(a.startswith(("mesh_", "pyramid_")) for a in sys.argv[1:]):
    # the mesh goldens and the pyramid sweep run on 8 virtual CPU devices
    # (tests/conftest.py; the resize's bits follow XLA's thread pool, which
    # that sizes to 8); the others keep the single device they were
    # written with
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()

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


# -- the loop-closing slice --------------------------------------------------

def _jfeatures(a):
    from orb_slam_fusion_tpu.frontend.extractor import Features
    return Features(**{n: jnp.asarray(a[n]) for n in Features._fields})


def loop_record(tr, rec, digest):
    out = record(tr, rec, digest)
    out.update(archived=len(tr.atlas),
               present=int(np.asarray(tr.loop_closer.db.present).sum()),
               closed=int(tr.loop_closer.num_closed))
    return out


def _loop_finish(tr, world, frames, extra, with_scale):
    g = finish(tr, world, frames, extra, with_scale=with_scale)
    lc = tr.loop_closer
    g.update(stats={k: (float(v) if isinstance(v, float) else int(v))
                    for k, v in lc.stats.items()},
             present_rows=np.nonzero(np.asarray(lc.db.present))[0].tolist(),
             archived=len(tr.atlas), loop_edges=[
                 [int(i), int(j)] for i, j, _ in lc.loop_edges])
    return g


def _step_event(before, after, rec, kind):
    """Did this frame merge a map (kind "merge") or recover a lost
    session by relocalization (kind "reloc")?"""
    if kind == "merge":
        return len(after.atlas) < before
    return rec.state == "ok" and before in ("LOST",)


def _carry(tr_copy, feats_np, step, k, ts, kind, path, extra):
    """Write a carried-state snapshot: the reference tracker's state
    before frame k (drained), the frame's inputs, and the reference's
    result of that one step from the drained state."""
    import gzip
    import pickle
    from test_torch_helpers import jax_tracker_state, table_digest, trim_state
    before = jax_tracker_state(tr_copy)
    n_arch = len(tr_copy.atlas)
    state0 = tr_copy.state.name
    rec = step(tr_copy)
    if not _step_event(n_arch if kind == "merge" else state0, tr_copy, rec,
                       kind):
        raise RuntimeError(f"{kind} did not recur from the drained state "
                           f"at frame {k}")
    after = trim_state(jax_tracker_state(tr_copy))
    # the descriptor tables after the step are held exactly: their digests
    # keep the file small
    for name in ("kf_desc", "mp_desc"):
        after["map"][name] = table_digest(after["map"][name])
    snap = dict(frame=k, timestamp=ts, inputs=feats_np,
                before=trim_state(before), after=after,
                rec=dict(state=rec.state, tracked=int(rec.tracked),
                         pose=(np.asarray(rec.pose.R),
                               np.asarray(rec.pose.t))),
                jax_version=jax.__version__,
                generated_by="tests/make_torch_goldens.py", **extra)
    with gzip.open(path, "wb") as fh:
        pickle.dump(snap, fh, protocol=4)
    print(f"wrote {os.path.basename(path)} at frame {k}", flush=True)


def mono_loop_session(cfg_dict, world_kw, render_kw, blackouts, n_frames,
                      grace=None, carry=None):
    """A MonoTracker session with loop closing on a corridor world, with
    empty frames in the blackouts; ``carry`` = (kind, path) writes the
    carried-state snapshot of the first such event."""
    import copy
    cfg = config_of(cfg_dict)
    world = sim.make_corridor_world(**world_kw)
    tr = MonoTracker(cfg)
    if grace is not None:
        tr.reloc_grace_frames = grace
    nf = cfg.orb.n_features
    frames = []
    done = carry is None
    for k in range(n_frames):
        if chip_smoke._blacked_out(k, blackouts):
            a = chip_smoke._empty_features_numpy(nf)
        else:
            f = sim.render_frame(world, k, jnp.asarray(cfg.cam_params),
                                 cfg.image_size, nf, **render_kw)
            a = {n: np.asarray(getattr(f, n)) for n in f._fields}
        ts = float(world.timestamps[k])
        want = (not done and (len(tr.atlas) > 0 if carry[0] == "merge"
                              else tr.state.name == "LOST"))
        snap = copy.deepcopy(tr) if want else None
        n_arch, st0 = len(tr.atlas), tr.state.name
        rec = tr.process_features(_jfeatures(a), ts)
        frames.append(loop_record(tr, rec, sha(*(a[n] for n in (
            "uv", "response", "octave", "angle", "desc", "valid")))))
        print("loop", k, frames[-1]["state"], frames[-1]["tracked"],
              frames[-1]["n_kf"], frames[-1]["archived"], flush=True)
        if snap is not None and _step_event(
                n_arch if carry[0] == "merge" else st0, tr, rec, carry[0]):
            _carry(snap, a, lambda t: t.process_features(_jfeatures(a), ts),
                   k, ts, carry[0], carry[1],
                   dict(config=cfg_dict, world=world_kw, render=render_kw,
                        blackouts=blackouts, grace=grace))
            done = True
    return _loop_finish(tr, world, frames, dict(
        config=cfg_dict, world=world_kw, render=render_kw,
        blackouts=[list(b) for b in blackouts], n_frames=n_frames,
        grace=grace), with_scale=True)


def _capture_loop_closures(tr, which, path, extra):
    """Wrap the reference's ``LoopCloser.try_close`` for this session:
    the calls on the frames of ``which`` ({frame: the merged map's loop
    number that call closes}, the tracker's ``_frame`` set by the caller)
    write a snapshot to ``path``: the tracker's state as that call saw it
    (the in-flight local and global BA dropped, as the correction drops
    them; their scattered iterates are in the map already; descriptors of
    keyframes the call does not read zeroed), and the reference's closer
    and the map fields it rewrites right after the call. Returns a
    function that undoes the wrap."""
    import copy
    import gzip
    import pickle
    from orb_slam_fusion_tpu.engine.loop_closing import LoopCloser
    from test_torch_helpers import (_trim_map, jax_loop_state,
                                    jax_map_to_numpy, jax_tracker_state,
                                    trim_state)
    orig = LoopCloser.try_close
    snaps = []

    def try_close(self, tracker):
        want = which.get(getattr(tracker, "_frame", None))
        before = copy.deepcopy(tracker) if want else None
        fired = orig(self, tracker)
        if before is None:
            return fired
        if not fired or self.num_closed != want or len(tracker.atlas):
            raise RuntimeError(f"frame {tracker._frame} did not close the "
                               f"merged map's loop {want}")
        before._pending_lba = None
        before.loop_closer.pending_gba = None
        state = jax_tracker_state(before)
        if not orig(before.loop_closer, before):
            raise RuntimeError("the carried loop closure did not recur")
        lc = before.loop_closer
        live = _trim_map(jax_map_to_numpy(before.map))
        after = dict(map={k: live[k] for k in LOOP_AFTER_FIELDS},
                     cur_pose=(np.asarray(before.cur_pose.R),
                               np.asarray(before.cur_pose.t)),
                     gba=lc.pending_gba is not None,
                     **jax_loop_state(before))
        # try_close reads the descriptors of the current keyframe and of
        # the candidate only (the database holds every keyframe's BoW
        # vector): the other rows are zeroed to keep the file small
        state = trim_state(state)
        cand, cur = lc.loop_edges[-1][:2]
        desc = state["map"]["kf_desc"]
        keep = np.zeros(desc.shape[0], bool)
        keep[[cand, cur]] = True
        state["map"]["kf_desc"] = np.where(keep[:, None, None], desc, 0)
        snaps.append(dict(frame=tracker._frame, kf=tracker.last_kf_id,
                          closed=want, before=state, after=after))
        print(f"captured loop closure {want} at frame {tracker._frame}",
              flush=True)
        if len(snaps) == len(which):
            with gzip.open(path, "wb") as fh:
                pickle.dump(dict(closures=snaps, jax_version=jax.__version__,
                                 generated_by="tests/make_torch_goldens.py",
                                 **extra), fh, protocol=4)
            print(f"wrote {os.path.basename(path)}", flush=True)
        return fired

    LoopCloser.try_close = try_close
    return lambda: setattr(LoopCloser, "try_close", orig)


# the map fields a loop closure rewrites (held after the carried call)
LOOP_AFTER_FIELDS = ("n_kf", "n_mp", "kf_pose", "kf_valid", "kf_obs_mp",
                     "mp_pos", "mp_normal", "mp_valid", "mp_ref_kf")


def stereo_vio_atlas_session(cfg_dict, carry=None, loop_carry=None):
    """StereoVioTracker with loop closing on test_inertial_merge.py's
    circle (vio_from_gt_trajectory), blackout 58-67. ``loop_carry`` =
    (closures, path) writes the carried loop-closure snapshots of the
    merged map (``_capture_loop_closures``)."""
    import copy
    from orb_slam_fusion_tpu.engine.vio_tracker import StereoVioTracker
    from orb_slam_fusion_tpu.imu.preintegration import make_calib
    import test_inertial_merge as tim
    cfg = config_of(cfg_dict)
    T, fps = chip_smoke.VIO_ATLAS_GT["n_frames"], chip_smoke.VIO_ATLAS_GT[
        "fps"]
    pos, quats, ts_ = tim._circle_gt(T, fps)
    # the port's rebuild of the test's circle must be the same inputs
    p2, q2, t2 = chip_smoke._circle_gt(T, fps)
    assert np.array_equal(q2, quats) and np.array_equal(p2, pos)
    seq = sim.vio_from_gt_trajectory(pos, quats, ts_,
                                     **chip_smoke.VIO_ATLAS_SEQ)
    world = seq.world
    tr = StereoVioTracker(cfg, chip_smoke.VIO_BASELINE, make_calib())
    tr.reloc_grace_frames = chip_smoke.ATLAS_GRACE
    nf = cfg.orb.n_features
    r = chip_smoke.VIO_ATLAS_RENDER
    frames = []
    undo = (_capture_loop_closures(tr, *loop_carry, dict(config=cfg_dict))
            if loop_carry else (lambda: None))
    done = carry is None
    for k in range(T):
        if chip_smoke._blacked_out(k, chip_smoke.VIO_ATLAS_BLACKOUTS):
            aL = chip_smoke._empty_features_numpy(nf)
            aR = chip_smoke._empty_features_numpy(nf)
        else:
            fL, fR = sim.render_stereo_frame(
                world, k, jnp.asarray(cfg.cam_params), cfg.image_size, nf,
                chip_smoke.VIO_BASELINE, **r)
            aL = {n: np.asarray(getattr(fL, n)) for n in fL._fields}
            aR = {n: np.asarray(getattr(fR, n)) for n in fR._fields}
        imu = chip_smoke._imu_of(seq, k)
        ts = float(world.timestamps[k])
        want = not done and len(tr.atlas) > 0
        snap = copy.deepcopy(tr) if want else None
        n_arch = len(tr.atlas)
        tr._frame = k

        def step(t):
            return t.process_stereo_imu(_jfeatures(aL), _jfeatures(aR), ts,
                                        *imu)
        rec = step(tr)
        digest = (sha(*(a[n] for a in (aL, aR) for n in (
            "uv", "response", "octave", "angle", "desc", "valid")))
            + sha(*imu))
        fr = loop_record(tr, rec, digest)
        fr.update(imu_stage=int(tr._imu_stage),
                  imu_initialized=bool(tr.imu_initialized))
        frames.append(fr)
        print("vio atlas", k, fr["state"], fr["tracked"], fr["n_kf"],
              fr["archived"], fr["imu_stage"], flush=True)
        if snap is not None and len(tr.atlas) < n_arch:
            _carry(snap, dict(left=aL, right=aR, imu=imu), step, k, ts,
                   "merge", carry, dict(config=cfg_dict))
            done = True
    undo()
    g = _loop_finish(tr, world, frames, dict(
        config=cfg_dict, gt=chip_smoke.VIO_ATLAS_GT,
        seq=chip_smoke.VIO_ATLAS_SEQ, render=r,
        blackouts=[list(b) for b in chip_smoke.VIO_ATLAS_BLACKOUTS],
        baseline=chip_smoke.VIO_BASELINE, grace=chip_smoke.ATLAS_GRACE),
        with_scale=False)
    # tests/test_inertial_merge.py's checks and its post-merge metric ATE
    start = int(T * 0.75)
    traj = tr.trajectory_tum()
    g["ate_tail_m"] = float(ate_rmse(
        traj[start:, 1:4], sim.gt_positions(world)[start:len(traj)],
        with_scale=False))
    g["inertial_tables"] = dict(
        n=[len(tr.kf_vel), len(tr.kf_bias), len(tr.kf_pre),
           len(tr.kf_time), len(tr.kf_raw)],
        kf_time_increasing=bool(np.all(np.diff(np.asarray(tr.kf_time)) > 0)),
        imu_initialized=bool(tr.imu_initialized))
    return g


def drive_closer_recorded(closer, tracker, K):
    """``test_loop_closing_e2e.drive_loop_closer`` with a record of every
    ``try_close``: whether it closed, the funnel counters, the consistency
    groups, the deferred detection's candidates and groups, the loop
    edges; on the closing step the corrected poses and point tables; at
    the end the poses after the drained global BA."""
    from test_torch_helpers import _trim_map, jax_map_to_numpy
    steps = []
    for k in range(max(0, K - 5), K):
        tracker.last_kf_id = k
        tracker.cur_pose = lie.SE3(tracker.map.kf_pose.R[k],
                                   tracker.map.kf_pose.t[k])
        fired = closer.try_close(tracker)
        pd = closer._pending_detect
        st = dict(k=k, fired=bool(fired), stats=dict(closer.stats),
                  cons_groups=[(sorted(g), c) for g, c in closer._cons_groups],
                  pending=None if pd is None else (np.asarray(pd[1]),
                                                   np.asarray(pd[2])),
                  edges=[(int(i), int(j), (np.asarray(S.s), np.asarray(S.R),
                                           np.asarray(S.t)))
                         for i, j, S in closer.loop_edges])
        if fired:
            live = _trim_map(jax_map_to_numpy(tracker.map))
            st["map"] = {k: live[k] for k in LOOP_AFTER_FIELDS}
        steps.append(st)
    closer.gba_drain(tracker)
    return dict(steps=steps, bow=np.asarray(closer.db.bow)[:K],
                present=np.asarray(closer.db.present)[:K],
                final_R=np.asarray(tracker.map.kf_pose.R)[:K],
                final_t=np.asarray(tracker.map.kf_pose.t)[:K])


def loop_closer_steps():
    """The JAX package's closer on the e2e test's three maps, recorded:
    the drifted loop with the flat 2,048-word vocabulary and with a tree
    vocabulary trained on the map (the file's bytes kept), and the
    aliased corridor (its map kept), for tests/test_torch_loop_closing.py."""
    import gzip
    import pickle
    import tempfile
    import test_loop_closing_e2e as e2e
    from orb_slam_fusion_tpu.engine.loop_closing import LoopCloser
    from orb_slam_fusion_tpu.place.tree_vocabulary import (
        save_tree_binary, train_vocabulary)
    from test_torch_helpers import jax_map_to_numpy

    m, _, _, cfg = e2e.build_drifted_loop_map()

    def drive(m, cfg, **kw):
        K = int(m.n_kf)
        tracker = e2e.FakeTracker(m, e2e.CAM, K - 1)
        closer = LoopCloser(cfg, cfg.max_keyframes, **kw)
        for k in range(K):
            closer.add_keyframe(k, m.kf_desc[k], m.kf_feat_valid[k])
        return drive_closer_recorded(closer, tracker, K)

    out = dict(flat=drive(m, cfg, vocab_words=2048))
    K = int(m.n_kf)
    desc = np.asarray(m.kf_desc[:K]).reshape(-1, 8)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "voc.bin")
        save_tree_binary(path, train_vocabulary(desc[:2000], k=8, levels=3,
                                                seed=1), levels=3)
        with open(path, "rb") as fh:
            out["tree_vocab_bin"] = fh.read()
        out["tree"] = drive(m, cfg._replace(vocab_path=path))
    captured = {}

    def capture(closer, tracker, m, K):
        captured.update(m=m, cfg=closer.cfg)
        return False
    orig = e2e.drive_loop_closer
    e2e.drive_loop_closer = capture
    try:
        e2e.test_aliased_single_hit_rejected()
    finally:
        e2e.drive_loop_closer = orig
    am, acfg = captured["m"], captured["cfg"]
    out["aliased_map"] = jax_map_to_numpy(am)
    out["aliased_cfg"] = dict(max_keyframes=acfg.max_keyframes,
                              max_map_points=acfg.max_map_points,
                              n_feat=acfg.orb.n_features)
    out["aliased"] = drive(am, acfg, vocab_words=2048)
    out.update(jax_version=jax.__version__,
               generated_by="tests/make_torch_goldens.py")
    with gzip.open(os.path.join(OUT, LOOP_STEPS_FILE), "wb") as fh:
        pickle.dump(out, fh, protocol=4)
    print("wrote", LOOP_STEPS_FILE, flush=True)


LOOP_STEPS_FILE = "loop_closer_steps.pkl.gz"


def loop_map():
    """tests/test_loop_closing_e2e.py's drifted loop map and the reference
    closer's results on it (flat vocabulary of 2048 words), for
    chip_smoke.py's loop_correct phase."""
    import test_loop_closing_e2e as e2e
    from orb_slam_fusion_tpu.engine.loop_closing import LoopCloser
    from test_torch_helpers import jax_map_to_numpy
    m, gt, _, cfg = e2e.build_drifted_loop_map()
    K = int(m.n_kf)
    fields = jax_map_to_numpy(m)
    tracker = e2e.FakeTracker(m, e2e.CAM, K - 1)
    closer = LoopCloser(cfg, cfg.max_keyframes, vocab_words=2048)
    for k in range(K):
        closer.add_keyframe(k, m.kf_desc[k], m.kf_feat_valid[k])
    out = {}
    for k in range(max(0, K - 5), K):
        tracker.last_kf_id = k
        tracker.cur_pose = lie.SE3(tracker.map.kf_pose.R[k],
                                   tracker.map.kf_pose.t[k])
        if closer.try_close(tracker):
            out["closed_at"] = np.asarray(k)
            out["corrected_R"] = np.asarray(tracker.map.kf_pose.R)
            out["corrected_t"] = np.asarray(tracker.map.kf_pose.t)
    closer.gba_drain(tracker)
    i, j, S = closer.loop_edges[0]
    out.update(edge=np.asarray([i, j]), edge_s=np.asarray(S.s),
               edge_R=np.asarray(S.R), edge_t=np.asarray(S.t),
               final_R=np.asarray(tracker.map.kf_pose.R),
               final_t=np.asarray(tracker.map.kf_pose.t),
               gt_R=np.stack([np.asarray(g.R) for g in gt]),
               gt_t=np.stack([np.asarray(g.t) for g in gt]),
               stats=np.asarray(json.dumps(closer.stats)),
               cam=np.asarray(e2e.CAM, np.float32),
               n_feat=np.asarray(e2e.N_FEAT),
               max_keyframes=np.asarray(cfg.max_keyframes),
               max_map_points=np.asarray(cfg.max_map_points))
    for k, v in fields.items():
        if k == "kf_pose":
            out["map.kf_pose.R"], out["map.kf_pose.t"] = v
        else:
            out[f"map.{k}"] = v
    np.savez_compressed(os.path.join(OUT, chip_smoke.LOOP_MAP_FILE), **out)
    print("wrote", chip_smoke.LOOP_MAP_FILE, "closed at",
          int(out["closed_at"]), flush=True)
    return None


SYSTEM = dict(settings="chip_smoke.SYSTEM_SETTINGS_YAML",
              seq=chip_smoke.VIO_SEQ, baseline=chip_smoke.STEREO_BASELINE,
              max_frames=chip_smoke.SYSTEM_MAX_FRAMES,
              after_init=chip_smoke.SYSTEM_AFTER_INIT,
              no_init_frames=chip_smoke.SYSTEM_NO_INIT_FRAMES)


def system_session():
    """The JAX package's ``System`` from ``chip_smoke.py``'s EuRoC
    settings file (stereo-inertial, the unrectified rig, 1200 features,
    loop closing on) over the mav0 tree ``chip_smoke.write_mav0`` writes
    from the stereo-inertial sequence, read back by the port's numpy
    ``EurocSequence`` (the card reads the same values), with raw 480x752
    pairs rendered at the EuRoC raw intrinsics; then the autosaved atlas
    restored into a second ``System``, a relocalization on the middle
    frame and localization mode over the next frames."""
    import shutil
    import tempfile
    from orb_slam_fusion_tpu.system import Sensor, System
    from orb_slam_fusion_tpu_torch.io import EurocSequence

    seq = sim.make_vio_sequence(**chip_smoke.VIO_SEQ)
    world = seq.world
    cam = jnp.asarray([chip_smoke.EUROC_K1[0][0], chip_smoke.EUROC_K1[1][1],
                       chip_smoke.EUROC_K1[0][2], chip_smoke.EUROC_K1[1][2]])
    size = (chip_smoke.IMG_H, chip_smoke.IMG_W)

    def inputs(k, fr):
        right = lie.SE3(world.poses.R[k], world.poses.t[k] + jnp.array(
            [-chip_smoke.STEREO_BASELINE, 0.0, 0.0]))
        raw = (sim.render_image(world, k, cam, size),
               sim.render_image(world, k, cam, size, pose_override=right))
        imu = (fr.imu_acc, fr.imu_gyro, fr.imu_t)
        return raw, imu, sha(*raw) + sha(*imu)

    def run(n_max, root):
        (path, load_path), atlas = chip_smoke.system_settings_files(root)
        chip_smoke.write_mav0(root, seq, n_max)
        frames_in = list(EurocSequence(root).frames())
        sys_ = System(settings_path=path, sensor=Sensor.IMU_STEREO)
        tr = sys_.tracker
        frames, init = [], None
        for k in range(n_max):
            raw, imu, digest = inputs(k, frames_in[k])
            rec = sys_.track_stereo_imu(*raw, frames_in[k].timestamp, *imu)
            frames.append(vio_record(tr, rec, digest))
            print("system", k, frames[-1]["state"], frames[-1]["tracked"],
                  frames[-1]["n_kf"], frames[-1]["imu_stage"], flush=True)
            if init is None and tr._imu_stage >= 1:
                init = k
            if init is not None and k >= init + chip_smoke.SYSTEM_AFTER_INIT:
                break
        return sys_, frames, init, load_path, frames_in

    root = tempfile.mkdtemp(prefix="osf_system_golden_")
    try:
        sys_, frames, init, load_path, frames_in = run(
            chip_smoke.SYSTEM_MAX_FRAMES, root)
        if init is None:
            shutil.rmtree(root)
            os.makedirs(root)
            sys_, frames, init, load_path, frames_in = run(
                chip_smoke.SYSTEM_NO_INIT_FRAMES, root)
        tr = sys_.tracker
        out = finish(tr, world, frames, dict(SYSTEM, imu_init_frame=init),
                     with_scale=False)
        out["loops_closed"] = int(tr.loop_closer.num_closed)
        out["loop_stats"] = {k: int(v) for k, v in tr.loop_closer.stats
                             .items() if isinstance(v, (int, np.integer))}
        sys_.shutdown()
        sys2 = System(settings_path=load_path, sensor=Sensor.IMU_STEREO)
        t2 = sys2.tracker
        k = len(frames) // 2
        raw, imu, _ = inputs(k, frames_in[k])
        before = t2.state.name
        rec = sys2.track_stereo_imu(*raw, frames_in[k].timestamp, *imu)
        out["reloc"] = dict(frame=k, before=before, after=t2.state.name,
                            state=rec.state, inliers=int(rec.tracked))
        n_kf = int(t2.map.n_kf)
        sys2.activate_localization_mode()
        loc = []
        for j in range(k + 1, k + 1 + chip_smoke.SYSTEM_LOCALIZATION_FRAMES):
            raw, imu, _ = inputs(j, frames_in[j])
            loc.append(sys2.track_stereo_imu(
                *raw, frames_in[j].timestamp, *imu).state)
        out["localization"] = dict(states=loc, n_kf_before=n_kf,
                                   n_kf_after=int(t2.map.n_kf))
        print("system reloc", out["reloc"], out["localization"], flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# tests/test_torch_system.py's monocular System session (JAX side, kept as
# a snapshot so the test runs the port alone): 16 frames of the tracker
# e2e world through track_monocular_features, the last 4 in localization
# mode
SYSTEM_MONO = dict(config=dict(cam_params=(400.0, 400.0, 376.0, 240.0),
                               image_size=(480, 752), n_features=256,
                               max_keyframes=16, max_map_points=2048,
                               ba_window=5, loop_closing=True,
                               vocab_words=1024),
                   world=dict(n_frames=40, n_points=4000, seed=3),
                   render_seed=11, frames=16, localization_from=12)
SYSTEM_MONO_FILE = "system_mono_session.json"
SYSTEM_MONO_ATLAS = "system_mono_atlas.npz"


def system_mono_session():
    import tempfile
    from orb_slam_fusion_tpu.system import Sensor, System
    spec = SYSTEM_MONO
    cfg = config_of(spec["config"])
    world = sim.make_corridor_world(**spec["world"])
    sys_ = System(sensor=Sensor.MONOCULAR, config=cfg, verbosity=0)
    tr = sys_.tracker
    cam = jnp.asarray(cfg.cam_params)
    frames = []
    for k in range(spec["frames"]):
        if k == spec["localization_from"]:
            sys_.activate_localization_mode()
        feats = sim.render_frame(world, k, cam, cfg.image_size,
                                 cfg.orb.n_features, seed=spec["render_seed"])
        rec = sys_.track_monocular_features(feats,
                                            float(world.timestamps[k]))
        frames.append(dict(record(tr, rec, feats_sha(feats)),
                           pose_R=np.asarray(rec.pose.R).tolist(),
                           pose_t=np.asarray(rec.pose.t).tolist()))
    sys_.deactivate_localization_mode()
    files = {}
    with tempfile.TemporaryDirectory() as d:
        for name in ("trajectory_tum", "trajectory_euroc", "trajectory_kitti",
                     "keyframe_trajectory_tum",
                     "keyframe_trajectory_euroc"):
            path = os.path.join(d, name + ".txt")
            getattr(sys_, "save_" + name)(path)
            with open(path) as f:
                files[name] = f.read()
        path = os.path.join(d, "viewer.html")
        sys_.save_interactive_viewer(path)
        with open(path) as f:
            files["viewer_html"] = f.read()
        debug = os.path.join(d, "debug.txt")
        sys_.save_debug_data(debug)
        with open(debug) as f:
            files["debug_first_line"] = f.readline()
    sys_.save_atlas(os.path.join(OUT, SYSTEM_MONO_ATLAS))
    return dict(spec, frames=frames, files=files,
                trajectory_tum=[[float(v) for v in r]
                                for r in tr.trajectory_tum()],
                tracked=sum(f["state"] in ("ok", "init-done")
                            for f in frames),
                n_kf=int(tr.map.n_kf), n_mp=int(tr.map.n_mp), ate_m=None,
                state_name=tr.state.name, jax_version=jax.__version__,
                generated_by="tests/make_torch_goldens.py")


ATLAS_CFG = {}                      # SlamConfig() as is
# the merged map's third and fourth loops, which the port's free-running
# main path does not reach (it parts from the golden on frame 22, PERF.md
# §6), carried instead: {frame: loop number}
VIO_LOOP_CLOSURES = {118: 3, 133: 4}
VIO_LOOP_FILE = "vio_loop_closures.pkl.gz"


LOOP_SESSIONS = {
    "loop_session_480x752.json": lambda: mono_loop_session(
        chip_smoke.LOOP_SESSION_CONFIG, chip_smoke.RELOC_WORLD,
        chip_smoke.RELOC_RENDER, chip_smoke.LOOP_SESSION_BLACKOUTS,
        chip_smoke.LOOP_SESSION_FRAMES),
    "atlas_session_480x752.json": lambda: mono_loop_session(
        ATLAS_CFG, chip_smoke.ATLAS_WORLD, chip_smoke.ATLAS_RENDER,
        chip_smoke.ATLAS_BLACKOUTS, chip_smoke.ATLAS_WORLD["n_frames"],
        grace=chip_smoke.ATLAS_GRACE),
    "reloc_session_480x752.json": lambda: mono_loop_session(
        ATLAS_CFG, chip_smoke.RELOC_WORLD, chip_smoke.RELOC_RENDER,
        chip_smoke.RELOC_BLACKOUTS, chip_smoke.RELOC_WORLD["n_frames"]),
    "stereo_vio_atlas_session_480x752.json": lambda: (
        stereo_vio_atlas_session(ATLAS_CFG, loop_carry=(
            VIO_LOOP_CLOSURES, os.path.join(OUT, VIO_LOOP_FILE)))),
    # carried-state snapshots at the atlas tests' widths (the session
    # goldens are written beside them)
    "atlas_test_session_480x752.json": lambda: mono_loop_session(
        chip_smoke.ATLAS_TEST_CONFIG, chip_smoke.ATLAS_WORLD,
        chip_smoke.ATLAS_RENDER, chip_smoke.ATLAS_BLACKOUTS,
        chip_smoke.ATLAS_WORLD["n_frames"], grace=chip_smoke.ATLAS_GRACE,
        carry=("merge", os.path.join(OUT, "atlas_merge_step.pkl.gz"))),
    "reloc_test_session_480x752.json": lambda: mono_loop_session(
        chip_smoke.ATLAS_TEST_CONFIG, chip_smoke.RELOC_WORLD,
        chip_smoke.RELOC_RENDER, chip_smoke.RELOC_BLACKOUTS[:1], 46,
        carry=("reloc", os.path.join(OUT, "reloc_step.pkl.gz"))),
    "vio_atlas_test_session_480x752.json": lambda: stereo_vio_atlas_session(
        chip_smoke.ATLAS_TEST_CONFIG,
        carry=os.path.join(OUT, "vio_merge_step.pkl.gz")),
}


def mesh_dryrun():
    """``__graft_entry__.dryrun_multichip(8)``'s four cases, built as it
    builds them, run on the 8-device mesh; inputs and results to
    ``mesh_dryrun.npz`` (keys ``ba.*``, ``pg.*``, ``vi.*``, ``tr.*``)."""
    from orb_slam_fusion_tpu.imu.factors import information_from_cov
    from orb_slam_fusion_tpu.imu.preintegration import (
        make_calib, preintegrate_host, zero_bias)
    from orb_slam_fusion_tpu.parallel import (
        distributed_bundle_adjustment, distributed_frame_update,
        distributed_pose_graph, distributed_visual_inertial_ba,
        make_slam_mesh, pad_map_for_mesh)
    from orb_slam_fusion_tpu.solver import ba
    from orb_slam_fusion_tpu.solver.pose_graph import PoseGraphProblem
    from orb_slam_fusion_tpu.solver.vi_ba import (InertialFactorBatch,
                                                  VIState)
    mesh = make_slam_mesh(devices=jax.devices()[:8])
    out = {}

    def put(prefix, **kw):
        for k, v in kw.items():
            out[f"{prefix}.{k}"] = np.asarray(v)

    # (1) sharded Schur BA: 64 keyframes, 8192 landmarks, 6 obs each
    K, M, OBS = 64, 8192, 6
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.uniform(-8, 8, (M, 3)), jnp.float32) \
        + jnp.array([0.0, 0.0, 10.0])
    poses = lie.se3_exp(jnp.asarray(
        np.concatenate([0.08 * rng.randn(K, 3),
                        0.02 * rng.randn(K, 3)], axis=1)
        + np.concatenate([np.linspace(0, 4, K)[:, None]
                          * np.array([[1.0, 0.0, 0.0]]),
                          np.zeros((K, 3))], axis=1), jnp.float32))
    base = np.asarray(rng.randint(0, K - OBS, M))
    kf_idx = jnp.asarray((base[:, None]
                          + np.arange(OBS)[None, :]).reshape(-1), jnp.int32)
    mp_idx = jnp.repeat(jnp.arange(M), OBS).astype(jnp.int32)
    cam = jnp.array([400.0, 400.0, 320.0, 240.0], jnp.float32)
    pc = lie.se3_apply(lie.SE3(poses.R[kf_idx], poses.t[kf_idx]),
                       pts[mp_idx])
    uv = cameras.pinhole_project(cam, pc)
    valid = pc[..., 2] > 0.2
    fixed = jnp.zeros(K, bool).at[0].set(True).at[1].set(True)
    poses0 = lie.se3_boxplus(poses, jnp.asarray(0.01 * rng.randn(K, 6),
                                                jnp.float32))
    pts0 = pts + jnp.asarray(0.05 * rng.randn(M, 3), jnp.float32)
    inv_s2 = jnp.ones(M * OBS)
    prob = ba.make_problem(poses0, pts0, kf_idx, mp_idx, uv, inv_s2, valid,
                           fixed, cam, max_obs=OBS)
    new_poses, new_points, costs = distributed_bundle_adjustment(
        prob, mesh, iters=3)
    put("ba", R=poses0.R, t=poses0.t, points=pts0, kf_idx=kf_idx,
        mp_idx=mp_idx, uv=uv, inv_s2=inv_s2, valid=valid, fixed=fixed,
        cam=cam, max_obs=OBS, iters=3, out_R=new_poses.R, out_t=new_poses.t,
        out_points=new_points, out_costs=costs)
    print("mesh_dryrun BA", np.asarray(costs), flush=True)

    # (2) pose graph on a drifted 64-node loop topology
    Kp = 64
    gt = []
    for k in range(Kp):
        ang = 2 * np.pi * k / Kp
        Rk = np.asarray(lie.so3_exp(jnp.array([0.0, ang, 0.0],
                                              jnp.float32)))
        tk = np.array([np.sin(ang) * 5, 0.0, 5 - np.cos(ang) * 5],
                      np.float32)
        gt.append(lie.Sim3(jnp.asarray(1.0, jnp.float32),
                           jnp.asarray(Rk, jnp.float32), jnp.asarray(tk)))
    ei, ej, rels = [], [], []
    for k in range(Kp - 1):
        ei.append(k)
        ej.append(k + 1)
        rels.append(lie.sim3_compose(gt[k + 1], lie.sim3_inverse(gt[k])))
    for k in range(0, Kp - 2, 2):
        ei.append(k)
        ej.append(k + 2)
        rels.append(lie.sim3_compose(gt[k + 2], lie.sim3_inverse(gt[k])))
    ei.append(Kp - 1)
    ej.append(0)
    rels.append(lie.sim3_compose(gt[0], lie.sim3_inverse(gt[Kp - 1])))
    rel_b = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *rels)
    drift = []
    for k in range(Kp):
        xi = np.zeros(7, np.float32)
        xi[:3] = rng.randn(3) * 0.08 * (k / Kp)
        xi[6] = 0.15 * (k / Kp)
        drift.append(lie.sim3_compose(lie.sim3_exp(jnp.asarray(xi)), gt[k]))
    init_b = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *drift)
    E = len(ei)
    pg = PoseGraphProblem(
        poses=init_b, edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32), edge_rel=rel_b,
        edge_weight=jnp.ones(E, jnp.float32), edge_valid=jnp.ones(E, bool),
        fixed=jnp.zeros(Kp, bool).at[0].set(True))
    pg_poses, pg_costs = distributed_pose_graph(pg, mesh, iters=10)
    put("pg", s=init_b.s, R=init_b.R, t=init_b.t, edge_i=pg.edge_i,
        edge_j=pg.edge_j, rel_s=rel_b.s, rel_R=rel_b.R, rel_t=rel_b.t,
        fixed=pg.fixed, iters=10, out_s=pg_poses.s, out_R=pg_poses.R,
        out_t=pg_poses.t, out_costs=pg_costs)
    print("mesh_dryrun PG", np.asarray(pg_costs), flush=True)

    # (3) distributed VI-BA: 15-dof states + preintegration chain
    Kv, Mv = 12, 1024
    calib = make_calib()
    dt, n_per = 5e-3, 50
    vel_w = np.array([0.4, 0.0, 0.1], np.float32)
    accs = np.tile(np.array([0.0, 0.0, 9.81], np.float32),
                   ((Kv - 1) * n_per, 1))
    gyros = np.zeros(((Kv - 1) * n_per, 3), np.float32)
    dts = np.full((Kv - 1) * n_per, dt, np.float32)
    p_wb = np.asarray([vel_w * (k * n_per * dt) for k in range(Kv)],
                      np.float32)
    R_cw = np.tile(np.eye(3, dtype=np.float32), (Kv, 1, 1))
    vi_poses = lie.SE3(jnp.asarray(R_cw), jnp.asarray(-p_wb))
    pres = [preintegrate_host(accs[k * n_per:(k + 1) * n_per],
                              gyros[k * n_per:(k + 1) * n_per],
                              dts[k * n_per:(k + 1) * n_per], zero_bias(),
                              calib) for k in range(Kv - 1)]
    pre_b = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *pres)
    info = jax.vmap(information_from_cov)(pre_b)
    ifac = InertialFactorBatch(
        i=jnp.arange(Kv - 1, dtype=jnp.int32),
        j=jnp.arange(1, Kv, dtype=jnp.int32),
        pre=pre_b, info=info, valid=jnp.ones(Kv - 1, bool))
    vpts = jnp.asarray(rng.uniform(-4, 4, (Mv, 3)), jnp.float32) \
        + jnp.array([0.0, 0.0, 8.0])
    vbase = np.asarray(rng.randint(0, Kv - 4, Mv))
    vkf = jnp.asarray((vbase[:, None] + np.arange(4)[None, :]
                       ).reshape(-1), jnp.int32)
    vmp = jnp.repeat(jnp.arange(Mv), 4).astype(jnp.int32)
    vpc = lie.se3_apply(lie.SE3(vi_poses.R[vkf], vi_poses.t[vkf]),
                        vpts[vmp])
    vuv = cameras.pinhole_project(cam, vpc)
    vvalid = vpc[..., 2] > 0.2
    vfixed = jnp.zeros(Kv, bool).at[0].set(True)
    vpts0 = vpts + jnp.asarray(0.03 * rng.randn(Mv, 3), jnp.float32)
    vprob = ba.make_problem(vi_poses, vpts0, vkf, vmp, vuv,
                            jnp.ones(Mv * 4), vvalid, vfixed, cam,
                            max_obs=4)
    dxi = jnp.asarray(0.01 * rng.randn(Kv, 6), jnp.float32).at[0].set(0.0)
    state0 = VIState(
        poses=lie.se3_boxplus(vi_poses, dxi),
        vel=jnp.broadcast_to(jnp.asarray(vel_w), (Kv, 3))
        + jnp.asarray(0.05 * rng.randn(Kv, 3), jnp.float32),
        bg=jnp.zeros((Kv, 3)) + 0.002, ba=jnp.zeros((Kv, 3)) + 0.02)
    vi_state, vi_points, vi_costs = distributed_visual_inertial_ba(
        state0, vprob, ifac, calib, mesh, fixed_pose=vfixed, iters=3)
    put("vi", R=state0.poses.R, t=state0.poses.t, vel=state0.vel,
        bg=state0.bg, ba=state0.ba, points=vpts0, kf_idx=vkf, mp_idx=vmp,
        uv=vuv, valid=vvalid, fixed=vfixed, cam=cam, max_obs=4, iters=3,
        ifac_i=ifac.i, ifac_j=ifac.j, ifac_info=info, ifac_valid=ifac.valid,
        out_R=vi_state.poses.R, out_t=vi_state.poses.t, out_vel=vi_state.vel,
        out_bg=vi_state.bg, out_ba=vi_state.ba, out_points=vi_points,
        out_costs=vi_costs)
    for f in pre_b._fields:
        v = getattr(pre_b, f)
        if f == "bias0":
            put("vi", pre_bias0_gyro=v.gyro, pre_bias0_acc=v.acc)
        else:
            out[f"vi.pre_{f}"] = np.asarray(v)
    for f in calib._fields:
        out[f"vi.calib_{f}"] = np.asarray(getattr(calib, f))
    print("mesh_dryrun VI", np.asarray(vi_costs), flush=True)

    # (4) distributed per-frame tracking: map sharded over the mesh
    Mt, Ft = 2048, 512
    desc = jnp.asarray(rng.randint(0, 2 ** 31, (Mt, 8)).astype(np.uint32))
    pose_t = lie.se3_exp(jnp.asarray(
        [0.02, -0.01, 0.03, 0.004, 0.006, -0.003], jnp.float32))
    pc_t = lie.se3_apply(pose_t, pts[:Mt])
    uv_t = cameras.pinhole_project(cam, pc_t)
    inb = ((uv_t[:, 0] >= 0) & (uv_t[:, 0] < 640)
           & (uv_t[:, 1] >= 0) & (uv_t[:, 1] < 480))
    sel = jnp.nonzero(inb, size=Ft, fill_value=0)[0]
    mp = pad_map_for_mesh(mesh, pts[:Mt], desc, jnp.ones(Mt, bool),
                          jnp.zeros(Mt, jnp.int32), jnp.zeros(Mt, jnp.int32))
    res = distributed_frame_update(
        *mp, lie.se3_identity(), lie.se3_identity(),
        uv_t[sel], desc[sel], inb[sel], jnp.ones(Ft), cam, mesh)
    put("tr", mp_pos=pts[:Mt], mp_desc=desc, kp_uv=uv_t[sel],
        kp_desc=desc[sel], kp_valid=inb[sel], cam=cam, true_R=pose_t.R,
        true_t=pose_t.t, out_R=res.pose.R, out_t=res.pose.t,
        out_match_idx=res.match_idx, out_inlier=res.inlier,
        out_mp_visible=res.mp_visible, out_mp_found=res.mp_found,
        out_counts=res.counts)
    print("mesh_dryrun track", np.asarray(res.counts), flush=True)
    out["jax_version"] = np.asarray(jax.__version__)
    np.savez_compressed(os.path.join(OUT, MESH_DRYRUN_FILE), **out)


MESH_DRYRUN_FILE = "mesh_dryrun.npz"
MESH_GBA_FILE = "mesh_gba_20kf.npz"
MESH_WORLD, MESH_RENDER = chip_smoke.MESH_WORLD, chip_smoke.MESH_RENDER


def mesh_session(cfg_dict):
    """``MonoTracker`` with ``mesh_devices`` on test_mesh_engine.py's
    corridor: per frame the state, inliers, counts and closed loops."""
    cfg = config_of(cfg_dict)
    world = sim.make_corridor_world(**MESH_WORLD)
    tr = MonoTracker(cfg)
    assert tr.mesh is not None and tr.mesh.shape["mp"] == 8
    cam = jnp.asarray(cfg.cam_params)
    nf = cfg.orb.n_features
    frames = []
    for k in range(MESH_WORLD["n_frames"]):
        f = sim.render_frame(world, k, cam, cfg.image_size, nf,
                             **MESH_RENDER)
        rec = tr.process_features(f, float(world.timestamps[k]))
        frames.append(loop_record(tr, rec, feats_sha(f)))
        print("mesh", k, frames[-1]["state"], frames[-1]["tracked"],
              frames[-1]["n_kf"], frames[-1]["n_mp"], flush=True)
    return _loop_finish(tr, world, frames, dict(
        config=cfg_dict, world=MESH_WORLD, render=MESH_RENDER),
        with_scale=True)


def mesh_gba():
    """The closer of ``loop_map()`` with a facade tracker on the 8-device
    mesh: the loop correction, then ``_global_ba_dist`` (synchronous)."""
    import test_loop_closing_e2e as e2e
    from orb_slam_fusion_tpu.engine.loop_closing import LoopCloser
    from orb_slam_fusion_tpu.parallel import make_slam_mesh
    m, _, _, cfg = e2e.build_drifted_loop_map()
    K = int(m.n_kf)
    tracker = e2e.FakeTracker(m, e2e.CAM, K - 1)
    tracker.mesh = make_slam_mesh(devices=jax.devices()[:8])
    closer = LoopCloser(cfg, cfg.max_keyframes, vocab_words=2048)
    for k in range(K):
        closer.add_keyframe(k, m.kf_desc[k], m.kf_feat_valid[k])
    out = {}
    for k in range(max(0, K - 5), K):
        tracker.last_kf_id = k
        tracker.cur_pose = lie.SE3(tracker.map.kf_pose.R[k],
                                   tracker.map.kf_pose.t[k])
        if closer.try_close(tracker):
            out["closed_at"] = np.asarray(k)
    assert closer.pending_gba is None
    i, j, _ = closer.loop_edges[0]
    out.update(edge=np.asarray([i, j]),
               final_R=np.asarray(tracker.map.kf_pose.R),
               final_t=np.asarray(tracker.map.kf_pose.t),
               final_mp_pos=np.asarray(tracker.map.mp_pos),
               n_mp=np.asarray(int(tracker.map.n_mp)),
               stats=np.asarray(json.dumps(closer.stats)))
    np.savez_compressed(os.path.join(OUT, MESH_GBA_FILE), **out)
    print("wrote", MESH_GBA_FILE, "closed at", int(out["closed_at"]),
          flush=True)


PYRAMID_SWEEP_FILE = "pyramid_sweep.json"


def pyramid_sweep_cases():
    """The seeded sweep of image shapes (both orientations, sides 64-800)
    and non-default pyramids that tests/test_torch_frontend.py holds the
    port's resize to: (h, w, levels, scale)."""
    rng = np.random.RandomState(2026)
    cases = [(int(h), int(w), 8, 1.2) for h, w in rng.randint(64, 801,
                                                              (48, 2))]
    return cases + [(480, 752, 12, 1.1), (480, 752, 4, 2.0),
                    (376, 1241, 6, 1.5), (640, 480, 10, 1.15),
                    (300, 500, 8, 1.3)]


def pyramid_sweep_image(h, w):
    return (np.random.RandomState(h * 7 + w).rand(h, w) * 255).astype(
        np.float32)


def pyramid_sweep():
    """Per-level digests of the reference's pyramids (one jit each) for
    ``pyramid_sweep_cases``, in the tests' regime."""
    from orb_slam_fusion_tpu.frontend import pyramid as jpyr
    build = jax.jit(jpyr.build_pyramid, static_argnums=(1, 2))
    out = {"regime": {"xla_force_host_platform_device_count": 8,
                      "xla_intra_op_threads": 8,
                      "jax": jax.__version__}, "cases": []}
    for h, w, levels, scale in pyramid_sweep_cases():
        lv = build(jnp.asarray(pyramid_sweep_image(h, w)), levels, scale)
        out["cases"].append({"h": h, "w": w, "levels": levels,
                             "scale": scale,
                             "digests": [sha(np.asarray(v)) for v in lv]})
    # chip_smoke.py's extraction phase: its textured images at sizes
    # outside the earlier verified list, the card's pyramid held to these
    from orb_slam_fusion_tpu_torch import synth
    out["chip"] = []
    for label, seed, h, w in chip_smoke.PYRAMID_IMAGES:
        img = synth.textured_image(np.random.RandomState(seed), h, w)
        lv = build(jnp.asarray(img), chip_smoke.N_LEVELS, 1.2)
        out["chip"].append({"label": label, "seed": seed, "h": h, "w": w,
                            "digests": [sha(np.asarray(v)) for v in lv]})
    with open(os.path.join(OUT, PYRAMID_SWEEP_FILE), "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", PYRAMID_SWEEP_FILE, len(out["cases"]), "cases",
          flush=True)


MESH_SESSIONS = {
    "mesh_session_480x752.json": lambda: mesh_session(
        chip_smoke.MESH_SESSION_CONFIG),
    "mesh_engine_session.json": lambda: mesh_session(
        chip_smoke.MESH_ENGINE_CONFIG),
}


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
            "vio_staged_session_480x752.json": vio_staged_session,
            "system_session_480x752.json": system_session,
            SYSTEM_MONO_FILE: system_mono_session,
            chip_smoke.LOOP_MAP_FILE: loop_map,
            LOOP_STEPS_FILE: loop_closer_steps,
            MESH_DRYRUN_FILE: mesh_dryrun,
            MESH_GBA_FILE: mesh_gba,
            PYRAMID_SWEEP_FILE: pyramid_sweep,
            **LOOP_SESSIONS, **MESH_SESSIONS}


def main():
    os.makedirs(OUT, exist_ok=True)
    names = sys.argv[1:] or list(SESSIONS)
    for name, fn in ((n, SESSIONS[n]) for n in names):
        t0 = time.perf_counter()
        if name in (chip_smoke.LOOP_MAP_FILE, LOOP_STEPS_FILE,
                    MESH_DRYRUN_FILE, MESH_GBA_FILE, PYRAMID_SWEEP_FILE):
            fn()
            continue
        g = fn()
        with open(os.path.join(OUT, name), "w") as fh:
            json.dump(g, fh, indent=1)
        print(f"wrote {name}: tracked {g['tracked']}, ATE {g['ate_m']}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
