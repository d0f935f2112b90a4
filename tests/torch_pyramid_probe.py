#!/usr/bin/env python3
"""Which image sizes get the reference's pyramid bits from the port.

    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py [HxW ...]
    JAX_PLATFORMS=cpu python tests/torch_pyramid_probe.py --step HxW:hxw

With ``--step``, probes one resize outside the pyramids instead: the
System's frame resize to a settings file's Camera.newHeight/newWidth
(``jax.image.resize(img, (h, w), "linear")``, run eagerly as
``System._preprocess`` runs it) against the port's height-first resize,
on six seeded images (uniform random, three of them rounded to integers)
and a rendered 480x752 frame; a step joins ``pyramid.RESIZE_STEPS`` only
when every image shows 0 differing pixels.

For each size, builds the 8-level pyramid of a seeded uniform-random image
with the reference (``jax.image.resize`` inside one jit, on the CPU) and
with the port, and prints per level the number of pixels that differ
(ROADMAP C3), bypassing the resize's refusal of sizes outside
``pyramid.VERIFIED_SIZES``: a size belongs in that list only when every
level is 0 here. Landscape sizes run the port's height-first order;
portrait sizes the width-first order the reference contracts them in
(both passes as the weights-on-the-left dot the port uses for the height
pass), to show how far that order gets.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from orb_slam_fusion_tpu.frontend import pyramid as jpyr  # noqa: E402
from orb_slam_fusion_tpu_torch.frontend import pyramid as tpyr  # noqa: E402

SIZES = ["752x480", "640x480", "300x120", "200x100", "1241x376", "848x800",
         "480x480", "256x256", "240x320", "120x300", "200x300", "300x400",
         "100x200", "96x128", "360x640", "376x752", "720x1280", "120x160",
         "240x376", "480x640", "376x1241", "800x848", "480x752",
         "370x1226", "375x1242", "400x640", "480x848", "540x960", "600x800",
         "768x1024", "1080x1920"]


def width_first(img, shape):
    """Portrait order: width pass, then height pass, both on the
    weights-on-the-left plan (``_resize_pass`` kind "h")."""
    out = img
    if shape[1] != img.shape[1]:
        out = tpyr._resize_pass(out, shape[1], "h")
    if shape[0] != img.shape[0]:
        out = tpyr._resize_pass(out.T, shape[0], "h").T
    return out.contiguous()


def probe_step(step):
    src, dst = ([int(v) for v in part.split("x")] for part in step.split(":"))
    imgs = []
    for seed in range(6):
        img = (np.random.RandomState(seed).rand(*src) * 255).astype(
            np.float32)
        imgs.append(np.round(img) if seed >= 3 else img)
    if tuple(src) == (480, 752):
        from orb_slam_fusion_tpu_torch import sim
        world = sim.make_corridor_world(n_frames=3, n_points=2000, seed=1)
        imgs.append(sim.render_image(world, 1, (458.654, 457.296, 367.215,
                                                248.375), (480, 752)))
    bad = []
    for img in imgs:
        ref = np.asarray(jax.image.resize(jnp.asarray(img), tuple(dst),
                                          "linear"))
        got = tpyr._resize_height_first(torch.from_numpy(img), tuple(dst))
        bad.append(int((ref != got.numpy()).sum()))
    listed = (tuple(src), tuple(dst)) in tpyr.RESIZE_STEPS
    print(f"{step}: differing px per image {bad}"
          + (" (in RESIZE_STEPS)" if listed else ""), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", default=SIZES)
    ap.add_argument("--step", action="append", default=[],
                    help="a resize HxW:hxw outside the pyramids")
    a = ap.parse_args()
    if a.step:
        for step in a.step:
            probe_step(step)
        return
    build = jax.jit(jpyr.build_pyramid, static_argnums=(1, 2))
    for size in a.sizes:
        h, w = (int(v) for v in size.split("x"))
        img = (np.random.RandomState(h * 7 + w).rand(h, w) * 255).astype(
            np.float32)
        ref = [np.asarray(v) for v in build(jnp.asarray(img), 8, 1.2)]
        resize = width_first if h > w else tpyr._resize_height_first
        lv = [torch.from_numpy(img)]
        for s in tpyr.level_shapes(h, w, 8, 1.2)[1:]:
            lv.append(resize(lv[-1], s))
        how = ("width first (not shipped)" if h > w else "height first") + (
            ", verified" if (h, w) in tpyr.VERIFIED_SIZES else "")
        bad = [int((a != b.numpy()).sum()) for a, b in zip(ref, lv)]
        print(f"{size}: differing px per level {bad} ({how})", flush=True)


if __name__ == "__main__":
    main()
