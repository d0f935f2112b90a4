#!/usr/bin/env python3
"""Which image sizes get the reference's pyramid bits from the port.

    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py [HxW ...]
    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py --cpus 1 [HxW ...]
    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py --step HxW:hxw
    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py --levels 12 \
        --scale 1.1 HxW

The reference's resize is two dots (``jax.image.resize``), and the order in
which XLA:CPU sums each output pixel's taps depends on the shape and on the
size of XLA's intra-op thread pool: the height pass (and both passes of a
portrait resize, whose operands are both transposed) is an Eigen
contraction that cuts the contracted axis into blocks by a cost model of
the shape and the thread count. XLA sizes that pool to the larger of the
host devices and the CPUs the process may run on, so the reference's bits
follow ``--xla_force_host_platform_device_count`` and ``taskset``. The port
reproduces the regime the reference runs in under tests/conftest.py and
the goldens (8 host devices: ``pyramid.REFERENCE_THREADS``); its resize
takes the thread count as an argument internally (``pyramid._resize``), so
other regimes can be checked.

By default the reference runs in that regime (8 host devices). With
``--cpus N`` it runs in a child process pinned to N CPUs
(``os.sched_setaffinity``) without the device-count flag, and the port
with N threads: the rule reproduces the reference on 1, 2, 3, 8 CPUs.

For each size, builds the pyramid of a seeded uniform-random image with
the reference (``jax.image.resize`` inside one jit) and with the port, each
level from the reference's previous level, and prints per level the number
of pixels that differ, or ``R`` where the port refuses the step (a class
named in ``pyramid._refused``; ROADMAP C3). With ``--step``, probes a resize
outside the pyramids instead (the System's frame resize to a settings
file's Camera.newHeight/newWidth, ``jax.image.resize(img, (h, w),
"linear")`` run eagerly) on six seeded images.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SIZES = ["752x480", "640x480", "300x120", "200x100", "1241x376", "848x800",
         "480x480", "256x256", "240x320", "120x300", "200x300", "300x400",
         "100x200", "96x128", "360x640", "376x752", "720x1280", "120x160",
         "240x376", "480x640", "376x1241", "800x848", "480x752",
         "370x1226", "375x1242", "400x640", "480x848", "540x960", "600x800",
         "768x1024", "1080x1920"]


def _child(argv, cpus):
    """Rerun this script pinned to ``cpus`` CPUs, without the device-count
    flag, and return its exit code."""
    env = dict(os.environ, XLA_FLAGS="", JAX_PLATFORMS="cpu",
               PYRAMID_PROBE_CHILD=str(cpus))
    return subprocess.call([sys.executable, os.path.abspath(__file__)]
                           + argv, env=env)


def _level_diffs(jax, jnp, np, torch, jpyr, tpyr, h, w, levels, scale,
                 threads):
    img = (np.random.RandomState(h * 7 + w).rand(h, w) * 255).astype(
        np.float32)
    build = jax.jit(jpyr.build_pyramid, static_argnums=(1, 2))
    ref = [np.asarray(v) for v in build(jnp.asarray(img), levels, scale)]
    out = []
    for lvl, s in enumerate(tpyr.level_shapes(h, w, levels, scale)[1:], 1):
        try:
            got = tpyr._resize(torch.from_numpy(ref[lvl - 1].copy()), s,
                               threads)
        except NotImplementedError:
            out.append("R")
            continue
        out.append(int((ref[lvl] != got.numpy()).sum()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", default=SIZES)
    ap.add_argument("--step", action="append", default=[],
                    help="a resize HxW:hxw outside the pyramids")
    ap.add_argument("--cpus", type=int, default=0,
                    help="run the reference on this many CPUs (no "
                         "device-count flag) and the port with as many "
                         "threads")
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--scale", type=float, default=1.2)
    a = ap.parse_args()
    child = int(os.environ.get("PYRAMID_PROBE_CHILD", "0"))
    if a.cpus and not child:
        sys.exit(_child(sys.argv[1:], a.cpus))
    if child:
        os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:child])
    else:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from orb_slam_fusion_tpu.frontend import pyramid as jpyr
    from orb_slam_fusion_tpu_torch.frontend import pyramid as tpyr

    torch.set_num_threads(1)
    threads = child or tpyr.REFERENCE_THREADS
    regime = (f"{child} CPUs, no device-count flag" if child else
              "8 host devices (the tests' regime)")
    print(f"reference on {regime}; port with {threads} threads", flush=True)
    if a.step:
        for step in a.step:
            src, dst = ([int(v) for v in part.split("x")]
                        for part in step.split(":"))
            bad = []
            for seed in range(6):
                img = (np.random.RandomState(seed).rand(*src) * 255).astype(
                    np.float32)
                img = np.round(img) if seed >= 3 else img
                ref = np.asarray(jax.image.resize(jnp.asarray(img),
                                                  tuple(dst), "linear"))
                got = tpyr._resize(torch.from_numpy(img), tuple(dst),
                                   threads)
                bad.append(int((ref != got.numpy()).sum()))
            print(f"{step}: differing px per image {bad}", flush=True)
        return
    for size in a.sizes:
        h, w = (int(v) for v in size.split("x"))
        bad = _level_diffs(jax, jnp, np, torch, jpyr, tpyr, h, w, a.levels,
                           a.scale, threads)
        print(f"{size}: differing px per level {bad}", flush=True)


if __name__ == "__main__":
    main()
