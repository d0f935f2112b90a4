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
  ``atan2f``, which XLA:CPU calls: see ``ic_angle`` and
  ``utils/libm.py``. Both are single-rounding float32 steps (on the card
  the ``libm`` kernel), so the CPU and CUDA give the reference's angle
  bits, and with them its steering bins.

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
from ..utils.libm import atan2 as atan2f
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
