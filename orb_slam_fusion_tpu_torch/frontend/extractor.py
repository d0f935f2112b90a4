"""ORB extraction: per-cell keypoint selection, IC angle and steered BRIEF.

Counterpart of ``orb_slam_fusion_tpu/frontend/extractor.py``: the same
fixed-capacity ``Features`` from the same image, bit for bit in keypoints,
octaves and descriptors. Two places need care:

* ``lax.top_k`` orders ties lowest index first and ``torch.topk`` does not,
  so selection is a stable descending sort (value, then lower index).
* The reference computes BRIEF bits for all 60 steering bins as one fp32
  product with a +-1 selection matrix. Each column of that matrix holds one
  +1 and one -1 (or nothing where the two rotated points coincide), so the
  product is exactly ``p[b] - p[a]``; the port gathers the two pixels of
  each pair directly and compares them, which gives the same bits without
  the 60x wider product (and without any TF32 question).

* The IC angle sums its moments in the order the reference's compiled
  einsum does (XLA:CPU, jax 0.9.0), and takes the arctangent as glibc's
  ``atan2f``, which XLA:CPU calls: see ``ic_angle`` and ``atan2f``. Both
  are written as single-rounding float32 steps, so the CPU and CUDA give
  the reference's angle bits, and with them its steering bins.

Descriptors are (N, 8) int32 holding the reference's uint32 bit patterns.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import fast as fast_mod
from . import pyramid as pyr_mod
from .orb_pattern import PATCH_RADIUS, PATTERN


class OrbParams(NamedTuple):
    """Extraction configuration (the reference's defaults)."""

    n_features: int = 1024
    num_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold_high: float = 20.0
    fast_threshold_low: float = 7.0
    cell_size: int = 32
    per_cell_k: int = 4
    edge_margin: int = 19
    subpixel: bool = False


class Features(NamedTuple):
    """Fixed-capacity feature set for one image.

    uv (N,2) float32 level-0 pixels; response (N,); octave (N,) int32;
    angle (N,) radians; desc (N,8) int32 bit patterns; valid (N,) bool.
    """

    uv: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def features_per_level(n_features: int, num_levels: int,
                       scale_factor: float) -> Tuple[int, ...]:
    """Geometric feature budget per level, totals fixed up on level 0."""
    f = 1.0 / scale_factor
    base = n_features * (1.0 - f) / (1.0 - f ** num_levels)
    per = [int(round(base * (f ** l))) for l in range(num_levels)]
    per[0] += n_features - sum(per)
    return tuple(per)


def _top_k_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, ties lowest index
    first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, n_out: int, cell: int,
                     per_cell_k: int, margin: int):
    """Up to n_out spatially distributed maxima of a score map.

    Returns (yx (n_out, 2) int32, score (n_out,), valid (n_out,) bool).
    """
    h, w = score.shape
    dev = score.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = ((ys >= margin) & (ys < h - margin)
           & (xs >= margin) & (xs < w - margin))
    score = torch.where(inb, score, torch.zeros_like(score))

    ph = (-h) % cell
    pw = (-w) % cell
    sp = torch.nn.functional.pad(score, (0, pw, 0, ph))
    hh, ww = sp.shape
    ncy, ncx = hh // cell, ww // cell
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)

    k = min(per_cell_k, cell * cell)
    top_v, top_i = _top_k_stable(cells, k)
    cid = torch.arange(ncy * ncx, device=dev)[:, None]
    yy = (cid // ncx) * cell + top_i // cell
    xx = (cid % ncx) * cell + top_i % cell

    cand_v = top_v.reshape(-1)
    cand_y = yy.reshape(-1)
    cand_x = xx.reshape(-1)
    n_cand = cand_v.shape[0]
    if n_cand < n_out:
        pad = n_out - n_cand
        cand_v = torch.nn.functional.pad(cand_v, (0, pad))
        cand_y = torch.nn.functional.pad(cand_y, (0, pad))
        cand_x = torch.nn.functional.pad(cand_x, (0, pad))
    sel_v, sel_i = _top_k_stable(cand_v, n_out)
    yx = torch.stack([cand_y[sel_i], cand_x[sel_i]], dim=-1).to(torch.int32)
    return yx, sel_v, sel_v > 0.0


def _circular_mask(radius: int = PATCH_RADIUS) -> np.ndarray:
    yy, xx = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    return (yy * yy + xx * xx <= radius * radius).astype(np.float32)


_UMAX_MASK = _circular_mask()


def gather_patches(img: torch.Tensor, yx: torch.Tensor,
                   radius: int = PATCH_RADIUS) -> torch.Tensor:
    """Batched (2r+1)x(2r+1) patches around integer centers yx (N,2)."""
    size = 2 * radius + 1
    h, w = img.shape
    y0 = torch.clamp(yx[:, 0].long() - radius, 0, h - size)
    x0 = torch.clamp(yx[:, 1].long() - radius, 0, w - size)
    off = torch.arange(size, device=img.device)
    rows = (y0[:, None] + off[None, :])[:, :, None]        # (N,S,1)
    cols = (x0[:, None] + off[None, :])[:, None, :]        # (N,1,S)
    return img.reshape(-1)[rows * w + cols]                # (N,S,S)


def _f32_words(*words: int):
    return [float(np.array(w, np.uint32).view(np.float32)) for w in words]


# glibc 2.36 sysdeps/ieee754/flt-32/s_atanf.c and e_atan2f.c (fdlibm), the
# float32 values its compiled tables hold (aT[0] is 0x3eaaaaab)
_ATANHI = _f32_words(0x3eed6338, 0x3f490fda, 0x3f7b985e, 0x3fc90fda)
_ATANLO = _f32_words(0x31ac3769, 0x33222168, 0x33140fb4, 0x33a22168)
_AT = _f32_words(0x3eaaaaab, 0xbe4ccccd, 0x3e124925, 0xbde38e38, 0x3dba2e6e,
                 0xbd9d8795, 0x3d886b35, 0xbd6ef16b, 0x3d4bda59, 0xbd15a221,
                 0x3c8569d7)
_PI, _PI_LO, _PI_O_2 = _f32_words(0x40490fdb, 0xb3bbbd2e, 0x3fc90fdb)
_ATAN_INF = float(np.float32(_ATANHI[3]) + np.float32(_ATANLO[3]))
_PI_O_2_LO = float(np.float32(_PI_O_2) + np.float32(0.5) * np.float32(_PI_LO))


def _atanf_pos(t: torch.Tensor) -> torch.Tensor:
    """glibc's ``atanf`` of non-negative float32 ``t``, branch-free: every
    argument reduction is computed and the right one selected, each step a
    single float32 rounding."""
    it = t.view(torch.int32)
    one = torch.ones_like(t)
    red = [(t * 2.0 - one) / (t + 2.0),          # 7/16 <= t < 11/16
           (t - one) / (t + one),                # 11/16 <= t < 19/16
           (t - 1.5) / (one + t * 1.5),          # 19/16 <= t < 39/16
           -one / t]                             # t >= 39/16
    idd = torch.where(it < 0x3F300000, 0, torch.where(
        it < 0x3F980000, 1, torch.where(it < 0x401C0000, 2, 3)))
    small = it < 0x3EE00000                      # t < 7/16: no reduction
    x = torch.where(small, t, torch.stack(red).gather(
        0, idd[None].long())[0])
    z = x * x
    w = z * z
    a = torch.full_like(t, _AT[10])
    for c in (_AT[8], _AT[6], _AT[4], _AT[2], _AT[0]):
        a = w * a + c
    b = torch.full_like(t, _AT[9])
    for c in (_AT[7], _AT[5], _AT[3], _AT[1]):
        b = w * b + c
    s = z * a + w * b
    hi = torch.tensor(_ATANHI, device=t.device)[idd.long()]
    lo = torch.tensor(_ATANLO, device=t.device)[idd.long()]
    out = torch.where(small, x - x * s, hi - ((x * s - lo) - x))
    out = torch.where(it < 0x31000000, t, out)   # t < 2^-29
    return torch.where(it >= 0x4C000000, torch.full_like(t, _ATAN_INF), out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atan2f`` (what XLA:CPU calls for ``jnp.arctan2``) for
    finite float32 tensors (NaN propagates), bit for bit on any device:
    ``torch.atan2`` and CUDA's ``atan2f`` round differently."""
    hx = x.view(torch.int32)
    hy = y.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    iy = hy & 0x7FFFFFFF
    k = (iy - ix) >> 23
    z = _atanf_pos(torch.abs(y / torch.where(ix == 0, torch.ones_like(x),
                                             x)))
    z = torch.where(k > 60, torch.full_like(z, _PI_O_2_LO), z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    pi = torch.full_like(z, _PI)
    neg_x = hx < 0
    neg_y = hy < 0
    out = torch.where(neg_x, torch.where(neg_y, (z - _PI_LO) - pi,
                                         pi - (z - _PI_LO)),
                      torch.where(neg_y, -z, z))
    # y = 0: +-0 towards +x, +-pi towards -x; x = 0: +-pi/2
    out = torch.where(iy == 0, torch.where(neg_x, torch.where(neg_y, -pi, pi),
                                           y), out)
    out = torch.where((ix == 0) & (iy != 0),
                      torch.where(neg_y, -_PI_O_2, _PI_O_2).to(z.dtype), out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation atan2(m01, m10) over a circular
    patch, (N, S, S) -> (N,) radians, with the reference's bits.

    The reference's ``einsum`` compiles (XLA:CPU, jax 0.9.0) into one loop
    fusion per moment: the masked patch summed over its other axis in
    increasing index, then a dot with the coordinates as fused
    multiply-adds. For ``m01`` that dot is one chain in increasing row;
    for ``m10`` it runs in 8 lanes over the first S - S % 8 columns
    (column x into lane x % 8), the lanes summed pairwise (0-3 + 4-7, then
    halves again), and the last S % 8 columns chained on in order. The
    products of a moment with an integer coordinate are exact in float64,
    so each fused multiply-add is a float64 add rounded once to float32.
    """
    n, size = patches.shape[0], patches.shape[-1]
    r = (size - 1) // 2
    dev = patches.device
    wimg = patches * _on_device("umax", size, dev)          # exact: 0/1
    both = torch.stack([wimg, wimg.transpose(1, 2)])        # (2, N, S, S)
    acc = torch.zeros((2, n, size), dtype=torch.float32, device=dev)
    for i in range(size):          # [0]: sum over rows, [1]: over columns
        acc += both[:, :, i]
    coords = torch.arange(size, dtype=torch.float64, device=dev) - r
    prods = acc.double() * coords                           # exact
    p10, p01 = prods[0], prods[1]
    m01 = torch.zeros(n, dtype=torch.float32, device=dev)
    for j in range(size):
        torch.add(p01[:, j], m01, out=m01)
    main = size - size % 8
    lanes = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    for j0 in range(0, main, 8):
        torch.add(p10[:, j0:j0 + 8], lanes, out=lanes)
    while lanes.shape[1] > 1:
        h = lanes.shape[1] // 2
        lanes = lanes[:, :h] + lanes[:, h:]
    m10 = lanes[:, 0].contiguous()
    for j in range(main, size):
        torch.add(p10[:, j], m10, out=m10)
    return atan2f(m01, m10)


BRIEF_ANGLE_BINS = 60  # 6-degree steering quantization


@functools.lru_cache(maxsize=8)
def _brief_pairs(size: int, bins: int) -> np.ndarray:
    """(bins, 256, 2) int64 flat patch offsets of (point a, point b) of each
    bit, rotated by the bin angle and rounded as the reference rounds them."""
    r = (size - 1) // 2
    pat = PATTERN.reshape(-1, 2).astype(np.float64)       # (512, 2) (dx, dy)
    out = np.zeros((bins, 256, 2), np.int64)
    for b in range(bins):
        ang = 2.0 * np.pi * b / bins
        ca, sa = np.cos(ang), np.sin(ang)
        ix = np.clip(np.round(ca * pat[:, 0] - sa * pat[:, 1]).astype(int)
                     + r, 0, size - 1)
        iy = np.clip(np.round(sa * pat[:, 0] + ca * pat[:, 1]).astype(int)
                     + r, 0, size - 1)
        flat = iy * size + ix
        out[b, :, 0] = flat[0::2]
        out[b, :, 1] = flat[1::2]
    return out


@functools.lru_cache(maxsize=16)
def _on_device(table: str, size: int, device: torch.device) -> torch.Tensor:
    """A constant table as a tensor on ``device``, copied there once."""
    if table == "umax":
        return torch.from_numpy(_UMAX_MASK[:size, :size]).to(device)
    return torch.from_numpy(_brief_pairs(size, BRIEF_ANGLE_BINS)).to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words, bit k of word j = bit 32j+k."""
    n = bits.shape[0]
    w = bits.reshape(n, 8, 32).to(torch.int64)
    sh = torch.arange(32, device=bits.device, dtype=torch.int64)
    v = torch.sum(w << sh, dim=-1)                          # [0, 2^32)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def brief_descriptors(patches: torch.Tensor, angles: torch.Tensor
                      ) -> torch.Tensor:
    """Rotation-steered BRIEF: (N,S,S) patches + (N,) angles -> (N,8) int32.

    Bit k is ``p[b_k] > p[a_k]`` with both pattern points rotated by the
    keypoint's angle bin (nearest of 60, angle wrapped to [0, 2pi))."""
    n, size = patches.shape[0], patches.shape[-1]
    pairs = _on_device("pairs", size, patches.device)
    two_pi = 2.0 * np.pi
    binf = torch.remainder(angles, two_pi) / two_pi * BRIEF_ANGLE_BINS
    bin_idx = torch.remainder(torch.round(binf).to(torch.int64),
                              BRIEF_ANGLE_BINS)
    pk = pairs[bin_idx]                                     # (N,256,2)
    flat = patches.reshape(n, -1)
    pa = torch.gather(flat, 1, pk[..., 0])
    pb = torch.gather(flat, 1, pk[..., 1])
    return pack_bits(pb - pa > 0)


def _harris_response(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Dense Harris response with 3x3 Sobel gradients and 3x3 smoothing."""
    def shift(a, dy, dx):
        return torch.roll(a, (dy, dx), dims=(0, 1))

    gx = (shift(img, 0, -1) - shift(img, 0, 1)) * 2.0 \
        + (shift(img, -1, -1) - shift(img, -1, 1)) \
        + (shift(img, 1, -1) - shift(img, 1, 1))
    gy = (shift(img, -1, 0) - shift(img, 1, 0)) * 2.0 \
        + (shift(img, -1, -1) - shift(img, 1, -1)) \
        + (shift(img, -1, 1) - shift(img, 1, 1))

    def box3(a):
        a = shift(a, -1, 0) + a + shift(a, 1, 0)
        return shift(a, 0, -1) + a + shift(a, 0, 1)

    sxx = box3(gx * gx)
    syy = box3(gy * gy)
    sxy = box3(gx * gy)
    return (sxx * syy - sxy * sxy) - k * (sxx + syy) ** 2


def _subpixel_offset(score: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """(N, 2) (dx, dy) in [-0.5, 0.5] from per-axis parabola fits."""
    h, w = score.shape
    y = torch.clamp(yx[:, 0].long(), 1, h - 2)
    x = torch.clamp(yx[:, 1].long(), 1, w - 2)
    s0 = score[y, x]

    def axis_off(sm, sp):
        denom = sm - 2.0 * s0 + sp
        zero = torch.zeros_like(denom)
        off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (sm - sp) / denom,
                          zero)
        return torch.where(denom < 0, torch.clamp(off, -0.5, 0.5), zero)

    dx = axis_off(score[y, x - 1], score[y, x + 1])
    dy = axis_off(score[y - 1, x], score[y + 1, x])
    return torch.stack([dx, dy], dim=-1)


def extract_features(img: torch.Tensor, params: OrbParams = OrbParams()
                     ) -> Features:
    """Full ORB pipeline on one (H, W) float32 image, on its device:
    ``build_pyramid`` then ``extract_from_pyramid``."""
    return extract_from_pyramid(
        pyr_mod.build_pyramid(img, params.num_levels, params.scale_factor),
        params)


def extract_from_pyramid(levels, params: OrbParams = OrbParams()
                         ) -> Features:
    """Per level: FAST -> NMS -> per-cell top-K -> IC angle -> steered
    BRIEF on the blurred level; levels merged into ``n_features`` slots
    (coordinates scaled to level 0)."""
    budgets = features_per_level(params.n_features, params.num_levels,
                                 params.scale_factor)
    dev = levels[0].device
    outs = {k: [] for k in Features._fields}
    patches = []
    for l, (lvl_img, budget) in enumerate(zip(levels, budgets)):
        if budget == 0:
            continue
        scale = params.scale_factor ** l
        score = fast_mod.detect(lvl_img, params.fast_threshold_high,
                                params.fast_threshold_low)
        yx, resp, valid = select_keypoints(
            score, budget, params.cell_size, params.per_cell_k,
            PATCH_RADIUS + 1)
        patches.append(gather_patches(pyr_mod.gaussian_blur(lvl_img), yx))
        xy = torch.stack([yx[:, 1].to(torch.float32),
                          yx[:, 0].to(torch.float32)], dim=-1)
        if params.subpixel:
            xy = xy + _subpixel_offset(_harris_response(lvl_img), yx)
        outs["uv"].append(xy * scale)
        outs["response"].append(resp)
        outs["octave"].append(torch.full((budget,), l, dtype=torch.int32,
                                         device=dev))
        outs["valid"].append(valid)
    # angles and descriptors of all levels at once (each keypoint's are
    # its own: batching changes no bits, only the launch count)
    patches = torch.cat(patches)
    outs["angle"] = [ic_angle(patches)]
    outs["desc"] = [brief_descriptors(patches, outs["angle"][0])]
    n = params.n_features
    return Features(**{k: torch.cat(v)[:n] for k, v in outs.items()})


def scale_sigma2(params: OrbParams, device=None) -> torch.Tensor:
    """Per-octave sigma^2 = scale^(2*level)."""
    return torch.tensor(
        [params.scale_factor ** (2 * l) for l in range(params.num_levels)],
        dtype=torch.float32, device=resolve_device(device))


def inv_scale_sigma2(params: OrbParams, device=None) -> torch.Tensor:
    return 1.0 / scale_sigma2(params, device)
