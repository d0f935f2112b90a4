#!/usr/bin/env python3
"""Which image sizes get the reference's pyramid bits from the port.

    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py [HxW ...]
    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py --cpus 1 [HxW ...]
    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py --step HxW:hxw
    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py --levels 12 \
        --scale 1.1 HxW
    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py --weights IN:OUT

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
of pixels that differ, or ``R`` where the port refuses the step (the one
class ``pyramid._refused`` names, a side of one pixel; ROADMAP C3). With
``--step``, probes a resize outside the pyramids instead (the System's frame
resize to a settings file's Camera.newHeight/newWidth,
``jax.image.resize(img, (h, w), "linear")`` run eagerly) on six seeded
images. With ``--weights IN:OUT``, reads the reference's compiled weights
for an IN -> OUT axis off its jitted resize of an IN x IN identity (each
output is one weight times 1.0, so no dot order enters) and prints the
entries that differ from ``pyramid.resize_weights``.

``--random MODE --count N --seed S`` holds the port to the reference on
many shapes and prints the count that differ (and are refused):
``weights`` (the identity read over in-sizes 2-33 and 82 out-sizes; no
count), ``passes`` (N seeded single passes, alternately the width pass of a
height-first step, YNNPACK's dot, and an Eigen pass, each against the
reference's ``lax.dot_general`` of the same layout; a third of the Eigen
passes end on a one-column n block, some on a one-row m block too; an
Eigen pass in the refused class counts as refused),
``steps`` (N seeded frame resizes, sides 2-899, down and up) and
``pyramids`` (N seeded pyramids, sides 16-1299, 4-12 levels, scale
1.1-2.0, each level from the reference's previous one). ``--port-root DIR``
imports the port from DIR instead (an unpacked earlier commit, to compare).
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


def _random(a, jax, jnp, np, torch, jpyr, tpyr, threads):
    """The ``--random`` sweeps: count the cases that differ and refuse."""
    from jax import lax
    rng = np.random.RandomState(a.seed)
    f32 = np.float32
    hi = lax.Precision.HIGHEST
    total = bad = refused = 0
    if a.random == "weights":
        outs = list(range(2, 72)) + [88, 95, 96, 100, 129, 200, 351, 352,
                                     353, 400, 401, 777]
        for n in range(2, 34):
            for m in outs:
                if m == n:
                    continue
                ref = np.asarray(jax.jit(lambda e: jax.image.resize(
                    e, (m, n), "bilinear"))(jnp.eye(n, dtype=f32))).T
                got = tpyr.resize_weights(n, m)
                total += 1
                if (ref.view(np.int32) != got.view(np.int32)).any():
                    bad += 1
                    print(f"  weights {n} -> {m} differ", flush=True)
    for i in range(a.count if a.random != "weights" else 0):
        total += 1
        try:
            if a.random == "passes":
                kind = "we"[i % 2]
                rows, k = int(rng.randint(2, 900)), int(rng.randint(2, 1500))
                out = (max(2, int(round(k / rng.uniform(1.05, 4.5))))
                       if rng.rand() < 0.75 else int(rng.randint(2, 1500)))
                if kind == "e" and rng.rand() < 0.35:
                    _, mcs, ncs, _ = tpyr._eigen_blocks(k, out, rows, threads)
                    out = max(2, out - out % ncs[0] + 1)
                    if rng.rand() < 0.4:
                        rows = max(2, rows - rows % mcs[0] + 1)
                out += out == k
                shape = (kind, rows, k, out)
                if kind == "e" and tpyr._over_three_shards(k, out, rows,
                                                           threads):
                    raise NotImplementedError(shape)
                x = (rng.rand(rows, k) * 255).astype(f32)
                w = tpyr.resize_weights(k, out)
                if kind == "w":
                    ref = lax.dot_general(x, w, (((1,), (0,)), ((), ())),
                                          precision=hi)
                else:
                    ref = lax.dot_general(w, x, (((0,), (1,)), ((), ())),
                                          precision=hi).T
                got = tpyr._resize_pass(torch.from_numpy(x), out, kind,
                                        threads).numpy()
                diff = int((np.asarray(ref) != got).sum())
            elif a.random == "steps":
                h, w = int(rng.randint(2, 900)), int(rng.randint(2, 900))
                c, d = (int(rng.randint(2, 900)) if rng.rand() < 0.3 else
                        max(2, int(round(s / rng.uniform(0.8, 3))))
                        for s in (h, w))
                c += (c, d) == (h, w)
                img = (rng.rand(h, w) * 255).astype(f32)
                shape = (h, w, c, d)
                ref = jax.jit(lambda v: jax.image.resize(
                    v, (c, d), "bilinear"))(jnp.asarray(img))
                got = tpyr._resize(torch.from_numpy(img), (c, d), threads)
                diff = int((np.asarray(ref) != got.numpy()).sum())
            else:
                h, w = int(rng.randint(16, 1300)), int(rng.randint(16, 1300))
                levels = int(rng.randint(4, 13))
                scale = float(rng.choice([1.1, 1.15, 1.2, 1.25, 1.3, 1.5,
                                          2.0]))
                shape = (h, w, levels, scale)
                per = _level_diffs(jax, jnp, np, torch, jpyr, tpyr, h, w,
                                   levels, scale, threads)
                if "R" in per:
                    raise NotImplementedError(per)
                diff = sum(per)
        except NotImplementedError:
            refused += 1
            print(f"  {shape}: R", flush=True)
            continue
        if diff:
            bad += 1
            print(f"  {shape}: {diff} differ", flush=True)
    print(f"random {a.random} (seed {a.seed}): {total} cases, {bad} differ, "
          f"{refused} refused", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", default=SIZES)
    ap.add_argument("--step", action="append", default=[],
                    help="a resize HxW:hxw outside the pyramids")
    ap.add_argument("--weights", action="append", default=[],
                    help="compare the weights of an IN:OUT axis")
    ap.add_argument("--random", choices=("weights", "passes", "steps",
                                         "pyramids"))
    ap.add_argument("--count", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port-root", default="")
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

    if a.port_root:
        sys.path.insert(0, os.path.abspath(a.port_root))
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
    print(f"reference on {regime}; port with {threads} threads "
          f"({os.path.relpath(tpyr.__file__)})", flush=True)
    for spec in a.weights:
        n, m = (int(v) for v in spec.split(":"))
        ref = np.asarray(jax.jit(lambda e: jax.image.resize(
            e, (m, n), "bilinear"))(jnp.eye(n, dtype=jnp.float32))).T
        got = tpyr.resize_weights(n, m)
        bad = np.argwhere(ref.view(np.int32) != got.view(np.int32))
        print(f"weights {n} -> {m}: {len(bad)} of {ref.size} differ "
              f"{[(int(k), int(j)) for k, j in bad[:8]]}", flush=True)
    if a.weights:
        return
    if a.random:
        _random(a, jax, jnp, np, torch, jpyr, tpyr, threads)
        return
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
                try:
                    got = tpyr._resize(torch.from_numpy(img), tuple(dst),
                                       threads)
                except NotImplementedError:
                    bad.append("R")
                    continue
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
