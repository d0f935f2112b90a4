"""Image pyramid and Gaussian blur.

Counterpart of ``orb_slam_fusion_tpu/frontend/pyramid.py``. The reference
downscales with ``jax.image.resize(..., "bilinear")``, which antialiases
when it shrinks: a triangle filter as wide as the scale step, applied as
one dot product per axis (height first). ``F.interpolate`` computes other
weights, so the port rebuilds the resize, rounded as the reference's CPU
build (jax 0.9, XLA:CPU) rounds it, so that the levels come out bit for
bit the same:

* the weights (``resize_weights``) follow XLA's two loop fusions: columns
  in the vectorised part round the sample position as an FMA and the tent
  as multiply-then-subtract; columns XLA unrolls or leaves to the scalar
  remainder round the other way round. The column totals are summed in
  windows of 32 rows, as XLA's tree reduction does;
* each output pixel sums only its 2-3 non-zero taps (``_taps``), in the
  order of the dot kernel XLA's CPU runtime picks for that shape
  (``_dot_plan``): a chain of fused multiply-adds in increasing input
  index, cut into blocks of the contracted axis, or 2 or 4 interleaved
  FMA chains summed pairwise plus a separately rounded tail.

These rules were read off the reference by probing its summation order.
The pyramids of the image sizes in ``VERIFIED_SIZES`` (120x160, 240x376,
480x752 and TUM-VI's 512x512, every shape the port runs, and KITTI's
375x1242 among them) are pinned bit-exact by
``tests/test_torch_frontend.py``. Other sizes reach orders not
reproduced yet (ROADMAP.md, C3): portrait images contract width first
with both dot operands transposed, and some landscape and square sizes
(240x320, 256x256, 480x480) reach another blocking regime at their
deeper levels.
``resize_bilinear`` raises for any step outside the verified pyramids
rather than return other bits. The
fused multiply-adds go through float64 (exact product, then two
roundings), the same bits on every device; in the rare case where the
float64 sum lands on a float32 tie they can differ from a true FMA by one
ulp. The blur is the reference's 2*(2r+1) shifted multiply-adds, rounded
as XLA's CPU build of it rounds them, so given the same level it is
bit-exact too.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def level_shapes(h: int, w: int, num_levels: int, scale: float
                 ) -> List[Tuple[int, int]]:
    shapes = []
    for l in range(num_levels):
        inv = 1.0 / (scale ** l)
        shapes.append((max(16, int(round(h * inv))),
                       max(16, int(round(w * inv)))))
    return shapes


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _fma(a: torch.Tensor, k: float, c: torch.Tensor) -> torch.Tensor:
    """float32 a*k + c rounded once (through float64: the product of two
    float32 values is exact there), the same bits on every device."""
    return (a.double() * k + c.double()).float()


def _blur_axis(take, k) -> torch.Tensor:
    # XLA's CPU compiler contracts the reference's sum of products into
    # fused multiply-adds: k0*x0 fused onto the rounded k1*x1, then one FMA
    # per further tap. Reproducing that keeps the blurred levels, and so the
    # BRIEF bits, identical to the reference's.
    out = _fma(take(0), k[0], (k[1] * take(1)).float())
    for i in range(2, len(k)):
        out = _fma(take(i), k[i], out)
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of a (H, W) image, edge-padded."""
    k = [float(v) for v in _gaussian_kernel1d(sigma, radius)]
    h, w = img.shape
    x = torch.cat([img[:1].expand(radius, w), img,
                   img[-1:].expand(radius, w)], dim=0)
    out = _blur_axis(lambda i: x[i:i + h], k)
    x = torch.cat([out[:, :1].expand(h, radius), out,
                   out[:, -1:].expand(h, radius)], dim=1)
    return _blur_axis(lambda i: x[:, i:i + w], k)


def _np_fma(a, b, c) -> np.ndarray:
    """float32 a*b + c through float64, as ``_fma``."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 antialiased triangle-filter weights, with
    the bits of the weights the reference's compiled resize computes."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    rk = f32(f32(1.0) / f32(max(float(inv_scale), 1.0)))
    pos = np.arange(out_size, dtype=f32) + f32(0.5)
    k = np.arange(in_size, dtype=f32)[:, None]
    # sample position: an FMA where XLA's loop computes it, two roundings
    # where it constant-folds it (unrolled or remainder columns)
    s_vec = _np_fma(pos, inv_scale, f32(-0.5))
    s_sca = (pos * inv_scale + f32(-0.5)).astype(f32)
    d_vec = np.abs(s_vec[None, :] - k).astype(f32)
    d_sca = np.abs(s_sca[None, :] - k).astype(f32)
    tent_vec = np.maximum(f32(1) - (d_vec * rk).astype(f32), f32(0))
    tent_sca = np.maximum(_np_fma(-d_sca, rk, f32(1)), f32(0))
    cols = np.arange(out_size)

    def vectorised(min_cols, width):
        if out_size < min_cols:           # XLA unrolls the whole row
            return np.zeros(out_size, bool)
        return cols < out_size - out_size % width

    fin = vectorised(88, 8)               # the normalising fusion
    tot = vectorised(352, 32)             # the fusion feeding the totals
    w = np.where(fin[None], tent_vec, tent_sca).astype(f32)
    wt = np.where(tot[None], tent_vec, tent_sca).astype(f32)
    pad = (-in_size) % 32
    wt = np.concatenate([np.zeros((pad // 2, out_size), f32), wt,
                         np.zeros((pad - pad // 2, out_size), f32)])
    total = np.zeros(out_size, f32)
    for r0 in range(0, wt.shape[0], 32):  # windows of 32, then across
        part = np.zeros(out_size, f32)
        for r in range(r0, r0 + 32):
            part = (part + wt[r]).astype(f32)
        total = (total + part).astype(f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    sample = np.where(fin, s_vec, s_sca)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _dot_plan(kind: str, rows: int, k: int, n: int):
    """How the reference's CPU dot sums over the contracted axis for one
    resize pass: ``("chain", block_starts)`` or ``("lanes", lanes, main,
    block_starts)``. ``kind`` "h" is the height pass (weights contracted
    on their rows), "w" the width pass; ``rows`` x ``n`` is the pass's
    output. In the lanes plan each k-block of 1024 has its own lanes,
    summed pairwise, and the blocks are added in order (read off a column
    whose taps straddle k = 1024 at 375x1242's level 2)."""
    if kind == "h":
        if k <= 320:
            return ("chain", (0,))
        blocks = -(-k // 320)
        kc = -(-(k // blocks) // 8) * 8
        return ("chain", tuple(range(0, k, kc)))
    if rows >= 51 and (n - 1) % 64 < 48:
        lanes = 4 if (n - 1) % 32 < 16 else 2
        return ("lanes", lanes, k - k % lanes, tuple(range(0, k, 1024)))
    return ("chain", tuple(range(0, k, 512)))


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int, kind: str, rows: int,
          device: torch.device):
    """Per output pixel, its non-zero taps and the accumulators the
    reference dot sums them in, on ``device``: (plan, index (T, out) long,
    weight (T, C, out) float64). Accumulator c of a column holds the tap's
    weight where the dot's order (``_dot_plan``) sends tap t to c, and an
    exact 0 elsewhere: a fused multiply-add of a finite pixel with weight 0
    leaves an accumulator's bits as they were, and one onto +0 is the
    rounded product, so every accumulator runs over all T taps unmasked.
    For a chain, c counts k-blocks from the column's first one; for lanes,
    c is the lane plus ``lanes`` times that block count (a column's taps
    straddle at most one block edge), and c = 2 * lanes the remainder."""
    w = resize_weights(in_size, out_size)
    nz = [np.nonzero(w[:, j])[0] for j in range(out_size)]
    T = max(1, max(len(t) for t in nz))
    idx = np.zeros((T, out_size), np.int64)
    ok = np.zeros((T, out_size), bool)
    for j, ks in enumerate(nz):
        idx[:len(ks), j] = ks
        ok[:len(ks), j] = True
    plan = _dot_plan(kind, rows, in_size, out_size)
    if plan[0] == "chain":
        block = np.searchsorted(np.asarray(plan[1]), idx, side="right") - 1
        acc = block - block[0]
        n_acc = int(acc[ok].max()) + 1
    else:
        lanes = plan[1]
        block = np.searchsorted(np.asarray(plan[3]), idx, side="right") - 1
        acc = np.where(idx < plan[2], (block - block[0]) * lanes
                       + idx % lanes, 2 * lanes)
        n_acc = 2 * lanes + 1
    t, j = np.nonzero(ok)
    wt = np.zeros((T, n_acc, out_size))
    wt[t, acc[t, j], j] = w[idx[t, j], j]
    as_t = lambda a: torch.from_numpy(a).to(device)    # noqa: E731
    return plan, as_t(idx), as_t(wt)


def _resize_pass(x: torch.Tensor, out_size: int, kind: str) -> torch.Tensor:
    """Resize the last axis of x (R, in) to (R, out_size), summing each
    output's taps in the reference dot's order (``_dot_plan``). A float32
    product is exact in float64, so (p + c) in float64 rounded to float32
    stands for a fused multiply-add (see the module docstring)."""
    rows = out_size if kind == "h" else x.shape[0]
    plan, idx, wt = _taps(x.shape[1], out_size, kind, rows, x.device)
    prods = x.double()[:, idx].unsqueeze(2) * wt       # (R, T, C, out)
    if plan[0] == "lanes":             # the remainder: mul, then add
        prods[:, :, -1] = prods[:, :, -1].float()
    acc = torch.zeros(prods[:, 0].shape, dtype=torch.float32,
                      device=x.device)
    for t in range(idx.shape[0]):      # one fused multiply-add per tap
        torch.add(prods[:, t], acc, out=acc)
    a = acc.unbind(1)
    if plan[0] == "chain":             # the k-blocks, in order
        out = a[0]
        for blk in a[1:]:
            out = out + blk
        return out
    def lanes(b):                      # one block's lanes, pairwise
        if plan[1] == 4:
            return (a[b] + a[b + 1]) + (a[b + 2] + a[b + 3])
        return a[b] + a[b + 1]

    return (lanes(0) + lanes(plan[1])) + a[-1]


# Image sizes whose 8-level, scale-1.2 pyramids are bit-exact against the
# reference's (tests/torch_pyramid_probe.py; jax 0.9.0 on the CPU), each
# pinned by tests/test_torch_frontend.py. Other sizes, portrait ones among
# them, reach dot orders not reproduced yet (ROADMAP C3).
VERIFIED_SIZES = ((96, 128), (100, 200), (120, 160), (240, 376), (360, 640),
                  (370, 1226), (375, 1242), (376, 752), (376, 1241),
                  (400, 640), (480, 640), (480, 752), (480, 848),
                  (512, 512), (540, 960), (600, 800), (720, 1280),
                  (768, 1024), (800, 848), (1080, 1920))
# resizes outside the pyramids, each verified bit-exact the same way: the
# System's frame resize to a settings file's Camera.newHeight/newWidth
# (``jax.image.resize(img, size, "linear")``; EuRoC to half size)
RESIZE_STEPS = (((480, 752), (240, 376)),)


@functools.lru_cache(maxsize=1)
def _verified_steps() -> frozenset:
    """The (input shape, output shape) pairs of the verified pyramids and
    of ``RESIZE_STEPS``."""
    steps = set(RESIZE_STEPS)
    for h, w in VERIFIED_SIZES:
        shapes = level_shapes(h, w, 8, 1.2)
        steps.update(zip(shapes[:-1], shapes[1:]))
    return frozenset(steps)


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]
                    ) -> torch.Tensor:
    """``jax.image.resize(img, shape, "bilinear")`` for a 2-D image, with
    the reference's bits. Raises for a resize that is not a step of a
    verified pyramid (``VERIFIED_SIZES``) or one of ``RESIZE_STEPS``
    rather than return other bits."""
    step = (tuple(img.shape), (int(shape[0]), int(shape[1])))
    if step not in _verified_steps():
        raise NotImplementedError(
            f"resize {step[0][0]}x{step[0][1]} -> {step[1][0]}x{step[1][1]} "
            f"is not a step of a pyramid verified to reproduce the "
            f"reference's bits (ROADMAP C3)")
    return _resize_height_first(img, shape)


def _resize_height_first(img: torch.Tensor, shape: Tuple[int, int]
                         ) -> torch.Tensor:
    """The resize in the landscape order: height pass, then width pass."""
    h, w = img.shape
    out = img
    if shape[0] != h:
        out = _resize_pass(out.T, shape[0], "h").T
    if shape[1] != w:
        out = _resize_pass(out, shape[1], "w")
    return out.contiguous()


def build_pyramid(img: torch.Tensor, num_levels: int = 8,
                  scale: float = 1.2) -> List[torch.Tensor]:
    """(H, W) float32 image -> list of per-level images."""
    h, w = img.shape
    shapes = level_shapes(h, w, num_levels, scale)
    levels = [img]
    for l in range(1, num_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels
