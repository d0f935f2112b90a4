#!/usr/bin/env python3
"""Write the golden runs ``chip_smoke.py`` holds the port's sessions to.

    JAX_PLATFORMS=cpu python tests/make_torch_goldens.py

Runs the JAX package's ``MonoTracker`` (``loop_closing=False``) on the CPU
over the two sessions ``chip_smoke.py`` drives, and writes, per session, a
JSON file under ``tests/torch_goldens/``: the configuration, world and
render arguments, and per frame the state, the inlier count, ``n_kf``,
``n_mp`` and a SHA-256 of the frame's inputs (the feature arrays, or the
image), then the tracked count, the ATE after init and the estimated
trajectory (TUM rows). The port's own
``sim.py`` regenerates the same inputs bit for bit, which the input hashes
let a run on another machine check.

* ``mono_session_480x752.json``: the tracker e2e sequence (corridor world,
  80 frames, seed 3) at ``SlamConfig``'s default widths (480x752, 1024
  features, 8192 map points, 256 keyframe slots, ``ba_window`` 8).
* ``image_session_240x376.json``: the image e2e sequence (gentle world,
  50 rendered 240x376 images through ``process_image``).

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
from orb_slam_fusion_tpu import sim  # noqa: E402
from orb_slam_fusion_tpu.engine import MonoTracker, SlamConfig  # noqa: E402
from orb_slam_fusion_tpu.frontend.extractor import OrbParams  # noqa: E402
from orb_slam_fusion_tpu.io import ate_rmse  # noqa: E402

OUT = os.path.join(HERE, "torch_goldens")

# the sessions exactly as chip_smoke.py runs them
MONO = dict(config=dict(loop_closing=False), world=chip_smoke.SESSION_WORLD,
            render=chip_smoke.SESSION_RENDER)
IMAGE = dict(config=json.loads(json.dumps(chip_smoke.IMAGE_CONFIG)),
             world=chip_smoke.IMAGE_WORLD)


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def finish(tr, world, frames, extra):
    states = [f["state"] for f in frames]
    start = states.index("init-done") if "init-done" in states else None
    traj = tr.trajectory_tum()
    ate = None
    if start is not None:
        ate = float(ate_rmse(traj[start:, 1:4],
                             sim.gt_positions(world)[start:len(traj)]))
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


def main():
    os.makedirs(OUT, exist_ok=True)
    for name, fn in (("mono_session_480x752.json", mono_session),
                     ("image_session_240x376.json", image_session)):
        t0 = time.perf_counter()
        g = fn()
        with open(os.path.join(OUT, name), "w") as fh:
            json.dump(g, fh, indent=1)
        print(f"wrote {name}: tracked {g['tracked']}, ATE {g['ate_m']}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
