"""Image pyramid and Gaussian blur.

Counterpart of ``orb_slam_fusion_tpu/frontend/pyramid.py``. The reference
downscales with ``jax.image.resize(..., "bilinear")``, which antialiases
when it shrinks: a triangle filter as wide as the scale step, applied as
one dot product per axis. ``F.interpolate`` computes other weights, so the
port rebuilds the resize, rounded as the reference's CPU build (jax 0.9,
XLA:CPU) rounds it, so that the levels come out bit for bit the same:

* the weights (``resize_weights``) follow XLA's two loop fusions as LLVM
  compiles them: vectorised loops round the sample position as an FMA and
  the tent as multiply-then-subtract, loops LLVM unrolls and folds round
  the other way round (``_tents``). The column totals are a reduce-window
  of 32 rows beyond 32 rows, and up to 32 rows one loop that LLVM either
  unrolls (rows in order) or vectorises (``_totals``);
* the axes go in ``jax.image.resize``'s einsum order: the height first,
  unless contracting the width first is cheaper (portrait steps), and
  then both dots have both operands transposed;
* each output pixel sums only its non-zero taps (``_taps``) in the order
  of the dot XLA's CPU runtime runs (``_dot_plan``). The width pass of a
  height-first step goes to YNNPACK, whose cost model picks a kernel (a
  fused multiply-add chain, 2 or 4 interleaved chains summed pairwise, or
  rounded products added in order), tiles the output and blocks k per
  tile (``_ynn_plan``). Every other pass is an Eigen tensor contraction on
  XLA's intra-op thread pool, which cuts the contracted axis into blocks by
  a cost model of the shape and of the pool's size (``_eigen_blocks``),
  and sums one row apart in 8 lanes when its last row block is one row
  wide (``_lone_taps``).

So the reference's bits depend on the thread count: XLA sizes its pool to
the larger of the host devices and the CPUs the process may run on. The
port reproduces the regime the reference runs in under tests/conftest.py
and the goldens, 8 host devices (``REFERENCE_THREADS``); ``resize_bilinear``
takes the count as an argument, and tests/torch_pyramid_probe.py --cpus N
holds it to the reference pinned to N CPUs. The probe's 31 sizes (landscape,
square and portrait) and a seeded sweep are pinned bit-exact by
tests/test_torch_frontend.py. Two classes of steps are not reproduced and
raise rather than return other bits (``_refused``, ROADMAP C3): a side of
the image or of the result of one pixel, and an Eigen pass shrinking about
30 times or more, where one output's taps meet three of its k shards.

The fused multiply-adds go through float64 (exact product, then two
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


def _tents(in_size: int, out_size: int) -> dict:
    """The tent filter (in, out) and the sample positions (out,) in the four
    roundings XLA's compiled fusions give them, keyed (position, tent): the
    position (j + 0.5) * scale - 0.5 as one FMA ("fma") or as a multiply
    then an add ("two": where LLVM folds it to a constant), and the tent
    1 - |s - k| * rk rounded once ("fma") or twice ("mul")."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    rk = f32(f32(1.0) / f32(max(float(inv_scale), 1.0)))
    pos = np.arange(out_size, dtype=f32) + f32(0.5)
    k = np.arange(in_size, dtype=f32)[:, None]
    out = {}
    for how, s in (("fma", _np_fma(pos, inv_scale, f32(-0.5))),
                   ("two", (pos * inv_scale + f32(-0.5)).astype(f32))):
        d = np.abs(s[None, :] - k).astype(f32)
        out[how, "mul"] = (np.maximum(f32(1) - (d * rk).astype(f32), f32(0)),
                           s)
        out[how, "fma"] = (np.maximum(_np_fma(-d, rk, f32(1)), f32(0)), s)
    return out


def _sum_rows(t: np.ndarray, lanes: int = 1, parts: int = 1) -> np.ndarray:
    """Column sums of t (rows, out) in float32, in the order of LLVM's loop
    vectorizer over the rows: ``parts`` interleaved accumulators of
    ``lanes`` lanes each take the rows' largest multiple of lanes * parts
    (row i to lane i % lanes of part (i // lanes) % parts), the parts are
    added in order, the lanes halved pairwise, and the rest of the rows
    added one by one. One lane and one part is the plain row order."""
    f32 = np.float32
    step = lanes * parts
    main = t.shape[0] - t.shape[0] % step if lanes > 1 else 0
    acc = t[:step].astype(f32) if main else np.zeros((1,) + t.shape[1:], f32)
    for r0 in range(step, main, step):
        acc = (acc + t[r0:r0 + step]).astype(f32)
    acc = acc.reshape((parts, lanes) + t.shape[1:]) if main else acc
    if main:
        acc = functools.reduce(lambda a, b: (a + b).astype(f32), acc)
        while len(acc) > 1:
            half = len(acc) // 2
            acc = (acc[:half] + acc[half:]).astype(f32)
    total = acc[0]
    for r in range(main, t.shape[0]):
        total = (total + t[r]).astype(f32)
    return total


def _totals(t: dict, in_size: int, out_size: int) -> np.ndarray:
    """The column totals of the tents as the reference's reduce fusion sums
    them (``_tents`` for the flavours)."""
    f32 = np.float32
    vec, sca = t["fma", "mul"][0], t["two", "fma"][0]
    if in_size > 32:
        # a reduce-window of 32 rows (centred in zero padding) and a reduce
        # across the windows; the row loop is vectorised over 32 columns
        # from 352 columns on, unrolled (constant positions) below
        cols = np.arange(out_size)
        tot = (cols < out_size - out_size % 32 if out_size >= 352
               else np.zeros(out_size, bool))
        wt = np.where(tot[None], vec, sca).astype(f32)
        pad = (-in_size) % 32
        wt = np.concatenate([np.zeros((pad // 2, out_size), f32), wt,
                             np.zeros((pad - pad // 2, out_size), f32)])
        total = np.zeros(out_size, f32)
        for r0 in range(0, wt.shape[0], 32):
            total = (total + _sum_rows(wt[r0:r0 + 32])).astype(f32)
        return total
    # up to 32 rows: one loop fusion, a loop over the columns around the
    # loop over the rows, which LLVM either unrolls whole (then it
    # vectorises the columns and the rows add in order) or vectorises
    if out_size > in_size:                # rk = 1: both tents round alike
        return _sum_rows(vec)
    if in_size <= 24:                     # the row loop unrolled
        if out_size <= 8:                 # ... and the fusion folded
            return _sum_rows(t["two", "mul"][0])
        # row 0's distance |s - 0| loses a fabs, so its tent is one FMA
        return _sum_rows(np.concatenate([t["fma", "fma"][0][:1], vec[1:]]))
    if in_size <= 27:                     # 8 lanes over 24 rows
        return _sum_rows(vec, 8)
    return _sum_rows(vec, 4, 2)           # 2 x 4 lanes over 24 rows


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 antialiased triangle-filter weights, with
    the bits of the weights the reference's compiled resize computes.

    Two fusions compute them: one sums the tents' columns (``_totals``),
    the other divides each tent by its column's total. Each rounds as
    LLVM compiled it for an AVX-512 host (256-bit vectors): where a
    loop is vectorised, the sample position is an FMA and the tent a
    multiply, then a subtraction; where LLVM unrolls a loop and folds the
    positions to constants, the other way round (``_tents``)."""
    f32 = np.float32
    t = _tents(in_size, out_size)
    cols = np.arange(out_size)
    if in_size in (4, 8) and out_size <= 11:
        w, sample = t["two", "mul"]       # LLVM folds the whole fusion
    else:
        # the column loop is vectorised by 8 from 88 columns on (96 when
        # enlarging, whose tent has no multiply), unrolled below
        fin = (cols < out_size - out_size % 8
               if out_size >= (96 if out_size > in_size else 88)
               else np.zeros(out_size, bool))
        w = np.where(fin[None], t["fma", "mul"][0], t["two", "fma"][0])
        sample = np.where(fin, t["fma", "mul"][1], t["two", "fma"][1])
    total = _totals(t, in_size, out_size)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


# --- the reference's dot schedule ---------------------------------------
# XLA:CPU runs a resize dot whose weights operand is contracted on its rows
# (the height pass, and both passes of a width-first resize) as an Eigen
# tensor contraction on its intra-op thread pool. Eigen cuts the contracted
# axis into blocks by a cost model of the shape and of the pool's thread
# count (TensorContractionThreadPool: sharding by the contracted axis,
# cost-based thread counts, cache blocking), refined by the contraction
# kernel XLA links in (equal k slices, m blocks of 48). Each block is summed
# on its own and the blocks are added in order, so the block edges are part
# of the bits. The functions below restate that schedule; Eigen's dims are
# m = the pass's other axis, n = its output axis, k = the contracted axis.

# The pool size the reference runs with in this repo: XLA:CPU sizes its
# intra-op pool to max(host devices, schedulable CPUs), and
# tests/conftest.py (like the goldens' generator) forces 8 host devices, so
# on hosts with up to 8 CPUs the reference contracts on 8 threads.
REFERENCE_THREADS = 8
# the caches of the x86 hosts the reference runs on (Eigen queries them):
# 48 KiB L1d, 2 MiB L2, 105 MiB L3; Eigen's float register block on AVX
_L1, _L2, _L3 = 48 * 1024, 2048 * 1024, 107520 * 1024
_MR, _NR = 16, 4
_LOAD = 11 / 64          # TensorCostModel: cycles per byte loaded/stored


def _divup(a: int, b: int) -> int:
    return -(-a // b)


def _blocking(k: int, m: int, n: int, nt: int, by_col: bool = True
              ) -> Tuple[int, int, int]:
    """Eigen's TensorContractionBlocking(k, m, n, nt) for a pool of nt > 1
    threads, with the refinement of the contraction kernel XLA links in
    (m blocks to 48s after x1.5, n blocks to 24s, k in equal slices of
    8s): (kc, mc, nc). Sharded by row, Eigen blocks with m and n swapped."""
    if not by_col:
        m, n = n, m
    kc, mc, nc = k, m, n
    k_cache = max(8, min((_L1 - _MR * _NR * 4) // (4 * (_MR + _NR)), 320))
    if k_cache < kc:
        kc = k_cache - k_cache % 8
    n_cache = (_L2 - _L1) // (_NR * 4 * kc)
    per = _divup(nc, nt)
    nc = (n_cache - n_cache % _NR if n_cache <= per
          else min(nc, _divup(per, _NR) * _NR))
    m_cache = (_L3 - _L2) // (4 * kc * nt)
    per = _divup(mc, nt)
    mc = (m_cache - m_cache % _MR if _MR <= m_cache < per
          else min(mc, _divup(per, _MR) * _MR))
    if not by_col:
        m, n, mc, nc = n, m, nc, mc
    return _refine(k, m, n, kc, mc, nc)


def _refine(k, m, n, kc, mc, nc) -> Tuple[int, int, int]:
    slices = max(1, _divup(k, kc))
    return (min(k, _divup(k // slices, 8) * 8),
            min(m, _divup(int(mc * 1.5), 48) * 48),
            min(n, _divup(nc, 24) * 24))


def _blocking_single(k: int, m: int, n: int) -> Tuple[int, int, int]:
    """Eigen's computeProductBlockingSizes on one thread, refined as in
    ``_blocking``: (kc, mc, nc)."""
    kc, mc, nc = k, m, n
    if max(k, m, n) >= 48:
        k_sub = _MR * _NR * 4
        max_kc = max(((_L1 - k_sub) // (4 * (_MR + _NR))) & ~7, 1)
        if kc > max_kc:
            kc = max_kc if kc % max_kc == 0 else max_kc - 8 * (
                (max_kc - 1 - kc % max_kc) // (8 * (kc // max_kc + 1)))
        l2 = 1572864                    # Eigen's conservative L2 share
        if _L1 - k_sub - m * kc * 4 >= _NR * 4 * kc:
            max_nc = (_L1 - k_sub - m * kc * 4) // (kc * 4)
        else:
            max_nc = 3 * l2 // (2 * 2 * max_kc * 4)
        cap = min(l2 // (2 * kc * 4), max_nc) & ~(_NR - 1)
        if n > cap:
            nc = cap if n % cap == 0 else cap - _NR * (
                (cap - n % cap) // (_NR * (n // cap + 1)))
        elif kc == k:                   # no blocking yet: block the rows
            lm, max_mc = l2, m
            if k * n * 4 <= 1024:
                lm = _L1
            elif k * n * 4 <= 32768:
                lm, max_mc = _L2, min(576, m)
            cap = min(lm // (3 * k * 4), max_mc)
            if cap > _MR:
                cap -= cap % _MR
            if cap > 0:
                mc = cap if m % cap == 0 else cap - _MR * (
                    (cap - m % cap) // (_MR * (m // cap + 1)))
    return _refine(k, m, n, kc, mc, nc)


def _shard_by_col(m: int, n: int, nt: int) -> bool:
    if (m // nt >= _NR and (n // nt < _NR or (
            n // nt < 4 * _NR and n % (nt * _NR) != 0
            and (m % (nt * _NR) == 0 or m // n >= 6)))):
        return False
    return not (n // nt < 16 * _NR and m > n * 32)


def _pool_threads(m: int, n: int, k: int, threads: int) -> int:
    """TensorCostModel::numThreads from the contraction's first blocking
    (on 2 threads): the thread count Eigen shards m x n over."""
    by_col = _shard_by_col(m, n, 2)
    bk, bm, bn = _blocking(k, m, n, 2, by_col)
    bw = 2.0 if (bm < _NR or bn < _MR) else 1.0   # Eigen built without FMA
    per = (bk * bw / 8 + _LOAD * 4
           + (0.0 if by_col else _LOAD * 4 * bk / n)
           + (_LOAD * 4 * bk / m if by_col else 0.0))
    cost = float(n) * m * per
    return min(threads, max(1, int((cost - 100000) / 100000 + 0.9)))


def _threads_by_k(m: int, n: int, k: int, threads: int) -> int:
    """numThreadsInnerDim: how many k shards the cost model prefers."""
    bw = 2.0 if (n < _NR or m < _MR) else 1.0
    total = k * (bw * m * n / 8 + _LOAD * 4 * n + _LOAD * 4)
    reduction = m * n * (_LOAD * 3 + 1 / 8)
    best, best_cost = 1, total
    for nt in range(2, threads + 1, 2):
        c = total / nt + 100000 + nt * (reduction + 3000)
        if c < best_cost:
            best, best_cost = nt, c
    return best


def _eigen_blocks(k: int, out: int, other: int, threads: int):
    """The k blocks of the reference's contraction for a pass contracting k
    into ``out`` outputs over ``other`` rows, the m and n block sizes its
    kernel calls see, and the starts of its k shards: ([(start, end)],
    [mc], [nc], shard_starts)."""
    m, n = other, out
    if threads > 1:
        nt = _pool_threads(m, n, k, threads)
        ntk = _threads_by_k(m, n, k, threads)
        if not (n == 1 or ntk < 2 or ntk < nt or m * n * 4 > _L3 // ntk
                or k // ntk < 2 * _NR) and (
                max(m, n) // nt < _NR or (k // ntk > 8 * _NR and (
                    min(m, n) < 2 * _NR or ntk > nt))):
            # sharded by k: shards of at least 96, each blocked again
            size = min(k, max(96, _divup(_divup(k, ntk), 8) * 8))
            shards = _divup(k, size)
            blocks, mcs, ncs = [], [], []
            for s in range(0, k, size):
                e = min(k, s + size)
                kc, mc, nc = _blocking(e - s, m, n, shards)
                blocks += [(a, min(e, a + kc)) for a in range(s, e, kc)]
                mcs.append(mc)
                ncs.append(nc)
            return blocks, mcs, ncs, tuple(range(0, k, size))
        if nt > 1:
            kc, mc, nc = _blocking(k, m, n, nt, _shard_by_col(m, n, nt))
            return ([(a, min(k, a + kc)) for a in range(0, k, kc)], [mc],
                    [nc], (0,))
    kc, mc, nc = _blocking_single(k, m, n)
    return [(a, min(k, a + kc)) for a in range(0, k, kc)], [mc], [nc], (0,)


def _split_long(s: int, e: int) -> List[int]:
    """The kernel's own cut of a k block longer than 384: in halves."""
    if e - s <= 384:
        return []
    h = s + _divup(e - s, 2)
    return _split_long(s, h) + [h] + _split_long(h, e)


# XLA:CPU hands the width pass of a height-first resize (image rows times
# the weights, contracted on the image's columns) to YNNPACK. Its dot picks
# a kernel by a cost model when XLA defines it (the rows not yet known),
# packs the weights for that kernel, splits the output into tiles at run
# time and picks a kernel again for each tile's shape, and blocks k so that
# the weights a tile reads at once fit 128 KiB. The restatement below reads
# jax 0.9.0's YNNPACK for an AVX-512 host; none of it depends on the thread
# count.

# YNNPACK's fp32 dot kernels in the order it tries them, as (block_m,
# block_n, block_k, cost of a block, fused multiply-add, tile_n). block_k is
# the kernel's k interleave: its lanes. The AVX and SSE2 kernels multiply,
# then add. (The AVX2 kernels without FMA tie the AVX2+FMA3 ones listed
# before them at every shape, and a tie keeps the first.)
_YNN_KERNELS = tuple(
    (bm, bn, bk, c, fused, tile_n) for fused, tile_n, rows in (
        (True, 16, ((1, 64, 1, 58), (2, 64, 1, 63), (3, 64, 1, 68),
                    (4, 64, 1, 73), (5, 64, 1, 78), (2, 32, 1, 41),
                    (3, 32, 1, 46), (4, 32, 1, 51), (5, 32, 1, 56),
                    (5, 16, 1, 45))),                   # avx512f, k1
        (True, 8, ((1, 32, 2, 58), (2, 32, 2, 63), (3, 32, 2, 68),
                   (4, 32, 2, 73), (5, 32, 2, 78), (4, 16, 2, 51),
                   (4, 8, 2, 40), (8, 8, 2, 60))),      # avx512f, k2
        (True, 4, ((1, 32, 4, 102), (2, 32, 4, 107), (3, 16, 4, 68),
                   (4, 16, 4, 73), (5, 16, 4, 78), (2, 8, 4, 41),
                   (4, 8, 4, 51), (6, 8, 4, 61), (4, 4, 4, 40),
                   (8, 4, 4, 60), (12, 4, 4, 80))),     # avx512f, k4
        (True, 8, ((1, 32, 1, 58), (2, 32, 1, 63), (1, 16, 1, 36),
                   (2, 16, 1, 41), (3, 16, 1, 46), (4, 16, 1, 51),
                   (5, 16, 1, 56), (6, 16, 1, 61), (8, 8, 1, 60))),  # fma3
        (True, 4, ((1, 16, 2, 58), (2, 16, 2, 63), (3, 8, 2, 46),
                   (4, 8, 2, 51), (5, 8, 2, 56), (6, 8, 2, 61),
                   (4, 4, 2, 40), (5, 4, 2, 45), (6, 4, 2, 50),
                   (8, 4, 2, 60))),                     # avx2 + fma3
        (False, 8, ((1, 32, 1, 58), (2, 32, 1, 63), (2, 16, 1, 41),
                    (3, 16, 1, 46), (4, 16, 1, 51), (4, 8, 1, 40),
                    (6, 8, 1, 50), (8, 8, 1, 60))),     # avx
        (False, 4, ((1, 16, 1, 58), (2, 16, 1, 63), (3, 16, 1, 68),
                    (2, 8, 1, 41), (3, 8, 1, 46), (4, 8, 1, 51),
                    (4, 4, 1, 40), (6, 4, 1, 50), (8, 4, 1, 60))))  # sse2
    for bm, bn, bk, c in rows)
# a k block keeps block_n x k_block x 4 bytes of the weights in this
_YNN_CACHE = 128 * 1024
# XLA defines the dot before it knows the rows: YNNPACK's default extent
_YNN_UNKNOWN = 2048
# from this many rows on, the weights are packed for the defined kernel
_YNN_PACK_ROWS = 51


def _ynn_cost(kern, m: int, n: int, k: int) -> np.float32:
    """YNNPACK's estimate_dot_cost, in its float32 steps."""
    f = np.float32
    return (f(f(f(_divup(m, kern[0])) * f(_divup(n, kern[1])))
              * f(_divup(k, kern[2]))) * f(kern[3]))


def _ynn_kernel(m: int, n: int, k: int, pool=_YNN_KERNELS):
    """get_dot_kernel: the cheapest kernel of ``pool``, the first of a tie."""
    best, cost = None, np.float32(np.inf)
    for kern in pool:
        c = _ynn_cost(kern, m, n, k)
        if c < cost:
            best, cost = kern, c
    return best


def _ynn_tiles(m: int, n: int, k: int, block_n: int) -> Tuple[int, int]:
    """The run-time split of the output into (rows, columns) tiles
    (YNNPACK's choose_split_factors): grow a tile from min(m, 16) x block_n
    by doubling until it holds min(m, 64) x min(n, 64) outputs and either
    it or its rows + columns over min(k, 1024) passes 65535 elements."""
    kk, target = min(k, 1024), min(n, 64) * min(m, 64)
    cols, rows = min(block_n, n), min(m, 16)
    while True:
        if rows * cols >= target and (rows * cols > 0xffff
                                      or (rows + cols) * kk > 0xffff):
            return rows, cols
        if cols < n and not (4 * cols >= rows and rows < m):
            cols *= 2
        elif rows >= m or (cols < n and rows >= 4 * cols):
            return rows, cols
        else:
            rows *= 2


def _ynn_sub(kern, k: int, block_n: int) -> tuple:
    """The plan of one tile: k blocks that keep block_n columns of the
    weights within ``_YNN_CACHE``, summed by the kernel's arithmetic."""
    bk = kern[2]
    kb = max(bk, _YNN_CACHE // (4 * block_n * bk) * bk)
    starts = tuple(range(0, k, kb))
    if bk > 1:
        return ("lanes", bk, k - k % bk, starts)
    return ("chain" if kern[4] else "mul", starts)


def _ynn_plan(k: int, out: int, other: int) -> tuple:
    """The reference's width pass as YNNPACK runs it: ("tiles", base,
    others), ``base`` the plan of most tiles and ``others`` the tiles
    ``(r0, r1, c0, c1, plan)`` that sum otherwise.

    The defined kernel is the cheapest for the unknown rows. From
    ``_YNN_PACK_ROWS`` rows on, the weights are packed for it: each tile
    picks among the kernels that read that packing, and k is blocked for
    the packed block_n. Below, a one-lane kernel that reads the weights as
    they are is kept unless it costs over twice the defined one; the tiles
    then span all rows, and each blocks k for its own width."""
    m = other
    best = _ynn_kernel(_YNN_UNKNOWN, out, k)
    fits = [kn for kn in _YNN_KERNELS
            if kn[2] == best[2] and best[1] % kn[5] == 0]
    packed = True
    if m < _YNN_PACK_ROWS and best[2] > 1:
        lane1 = _ynn_kernel(_YNN_UNKNOWN, out, k,
                            [kn for kn in _YNN_KERNELS if kn[2] == 1])
        if (_ynn_cost(lane1, _YNN_UNKNOWN, out, k)
                <= 2 * _ynn_cost(best, _YNN_UNKNOWN, out, k)):
            best, packed = lane1, False
    elif m < _YNN_PACK_ROWS:
        packed = False
    if not packed:
        fits = [kn for kn in _YNN_KERNELS if kn[2] == 1]
    rows, cols = _ynn_tiles(m, out, k, best[1])
    if not packed or m < _YNN_PACK_ROWS:
        rows = m
    tiles = []
    for r0 in range(0, m, rows):
        for c0 in range(0, out, cols):
            mt, nt = min(rows, m - r0), min(cols, out - c0)
            kern = _ynn_kernel(mt, nt, k, fits)
            tiles.append((r0, r0 + mt, c0, c0 + nt,
                          _ynn_sub(kern, k, best[1] if packed else nt)))
    subs = [t[4] for t in tiles]
    base = max(dict.fromkeys(subs), key=subs.count)
    return ("tiles", base, tuple(t for t in tiles if t[4] != base))


@functools.lru_cache(maxsize=512)
def _dot_plan(kind: str, k: int, out: int, other: int,
              threads: int = REFERENCE_THREADS):
    """How the reference's CPU dot sums over the contracted axis k for one
    resize pass of ``other`` rows into ``out`` outputs.

    Kind "w", the width pass of a height-first resize, is YNNPACK's dot
    (``_ynn_plan``), the same on any thread count: ``("tiles", base,
    others)``, each plan one of ``("chain", block_starts)``, ``("mul",
    block_starts)`` (a kernel without FMA: each product rounded, then
    added) or ``("lanes", lanes, main, block_starts)`` (each k-block's lanes
    summed pairwise, the blocks added in order). Kind "e" is every other
    pass (Eigen, see ``_eigen_blocks``): ``("chain", block_starts, lone,
    col)``, where
    ``lone`` is None, or, when the kernel's last m block is one row wide,
    the Eigen block starts that row (the pass's last ``other`` row) is
    summed over in 8 lanes (``_lone_taps``); ``col`` is None, or, when its
    last n block is one column wide, the k shard starts of the one chain
    the last column is summed in."""
    if kind == "w":
        return _ynn_plan(k, out, other)
    blocks, mcs, ncs, shards = _eigen_blocks(k, out, other, threads)
    starts = []
    for s, e in blocks:
        starts += [s] + _split_long(s, e)
    lone = None
    if any(other % mc == 1 or other == 1 for mc in mcs):
        lone = tuple(s for s, _ in blocks)
    # a last n block one column wide: the kernel runs it as a matrix-vector
    # product that adds each k block onto the output, one chain per shard
    col = shards if any(out % nc == 1 for nc in ncs) else None
    return ("chain", tuple(starts), lone, col)


@functools.lru_cache(maxsize=64)
def _tap_table(in_size: int, out_size: int):
    """Per output pixel its non-zero taps: (index (T, out), ok (T, out))."""
    w = resize_weights(in_size, out_size)
    nz = [np.nonzero(w[:, j])[0] for j in range(out_size)]
    T = max(1, max(len(t) for t in nz))
    idx = np.zeros((T, out_size), np.int64)
    ok = np.zeros((T, out_size), bool)
    for j, ks in enumerate(nz):
        idx[:len(ks), j] = ks
        ok[:len(ks), j] = True
    return w, idx, ok


def _weights(w, idx, ok, acc, n_acc, device):
    """(index (T, out), weight (T, C, out) float64) on ``device``: weight
    c of tap t is its weight where the order sends it to accumulator c, an
    exact 0 elsewhere (see ``_taps``)."""
    t, j = np.nonzero(ok)
    wt = np.zeros(idx.shape[:1] + (n_acc,) + idx.shape[1:])
    wt[t, acc[t, j], j] = w[idx[t, j], j]
    as_t = lambda a: torch.from_numpy(a).to(device)    # noqa: E731
    return as_t(idx), as_t(wt)


@functools.lru_cache(maxsize=128)
def _taps(in_size: int, out_size: int, plan: tuple, device: torch.device):
    """Per output pixel, its non-zero taps and the accumulators the
    reference dot sums them in, on ``device``: (index (T, out) long,
    weight (T, C, out) float64). Accumulator c of a column holds the tap's
    weight where the dot's order (``_dot_plan``) sends tap t to c, and an
    exact 0 elsewhere: a fused multiply-add of a finite pixel with weight 0
    leaves an accumulator's bits as they were, and one onto +0 is the
    rounded product, so every accumulator runs over all T taps unmasked.
    For a chain (and "mul"), c counts k-blocks from the column's first one;
    for lanes, c is the lane plus ``lanes`` times that block count, and the
    last accumulator takes the remainder past ``main``."""
    w, idx, ok = _tap_table(in_size, out_size)
    starts = np.asarray(plan[-1])
    block = np.searchsorted(starts, idx, side="right") - 1
    block = block - block[0]
    if plan[0] != "lanes":
        return _weights(w, idx, ok, block, int(block[ok].max()) + 1, device)
    lanes, n_acc = plan[1], (int(block[ok].max()) + 1) * plan[1] + 1
    acc = np.where(idx < plan[2], block * lanes + idx % lanes, n_acc - 1)
    return _weights(w, idx, ok, acc, n_acc, device)


@functools.lru_cache(maxsize=64)
def _lone_taps(in_size: int, out_size: int, starts: tuple,
               device: torch.device):
    """The taps of the pass's last row where the kernel sums it alone: per
    Eigen k block (``starts``), 8 lanes of fused multiply-adds over k
    (relative to the block's start) on its largest multiple of 16, then the
    rest as rounded products in groups of 8, 4, 2 and 1. Accumulators: 23
    per block (8 lanes, 8, 4, 2, 1), counted from the output's first block;
    a window of taps meets at most two blocks."""
    w, idx, ok = _tap_table(in_size, out_size)
    st = np.asarray(starts)
    ends = np.append(st[1:], in_size)
    block = np.searchsorted(st, idx, side="right") - 1
    rel = idx - st[block]
    length = (ends - st)[block]
    main = length - length % 16
    r = rel - main                      # position within the tail
    g8, g4, g2 = (length & 8), (length & 4), (length & 2)
    slot = np.where(rel < main, rel % 8,
                    np.where(r < g8, 8 + r,
                             np.where(r < g8 + g4, 16 + r - g8,
                                      np.where(r < g8 + g4 + g2,
                                               20 + r - g8 - g4, 22))))
    acc = (block - block[0]) * 23 + slot
    return _weights(w, idx, ok, acc, 46, device)


def _accumulate(x: torch.Tensor, idx: torch.Tensor, wt: torch.Tensor,
                rounded: slice = slice(0)) -> Tuple[torch.Tensor, ...]:
    """Each accumulator's fused multiply-add chain over the taps (a float32
    product is exact in float64, so (p + c) in float64 rounded to float32
    stands for a fused multiply-add): (R, out) tensors, one per
    accumulator. The accumulators in ``rounded`` multiply, then add (the
    lanes plan's remainder, every accumulator of a kernel without FMA)."""
    prods = x.double()[:, idx].unsqueeze(2) * wt       # (R, T, C, out)
    prods[:, :, rounded] = prods[:, :, rounded].float()
    acc = torch.zeros(prods[:, 0].shape, dtype=torch.float32,
                      device=x.device)
    for t in range(idx.shape[0]):      # one fused multiply-add per tap
        torch.add(prods[:, t], acc, out=acc)
    return acc.unbind(1)


def _lone_sum(a) -> torch.Tensor:
    """Combine ``_lone_taps``' accumulators as the kernel does: per block
    the 8 lanes ((l0+l1)+(l4+l5))+((l2+l3)+(l6+l7)), plus the group of 8
    reduced alike, then the group of 4 summed pairwise, then the pair, then
    the single; the blocks in order."""
    def eight(l):
        return ((l[0] + l[1]) + (l[4] + l[5])) + ((l[2] + l[3]) + (l[6] + l[7]))

    def block(b):
        l = a[b:b + 23]
        out = eight(l[0:8]) + eight(l[8:16])
        out = out + ((l[16] + l[17]) + (l[18] + l[19]))
        return (out + (l[20] + l[21])) + l[22]
    return block(0) + block(23)


def _resize_pass(x: torch.Tensor, out_size: int, kind: str,
                 threads: int = REFERENCE_THREADS) -> torch.Tensor:
    """Resize the last axis of x (R, in) to (R, out_size), summing each
    output's taps in the reference dot's order (``_dot_plan``)."""
    plan = _dot_plan(kind, x.shape[1], out_size, x.shape[0], threads)
    if kind == "w":                    # the tiles that sum otherwise last
        out = _resize_rows(x, out_size, plan[1])
        for sub in dict.fromkeys(t[4] for t in plan[2]):
            box = [t for t in plan[2] if t[4] == sub]
            r0, c0 = min(t[0] for t in box), min(t[2] for t in box)
            blk = _resize_rows(x[r0:max(t[1] for t in box)], out_size, sub,
                               slice(c0, max(t[3] for t in box)))
            for t in box:
                out[t[0]:t[1], t[2]:t[3]] = blk[t[0] - r0:t[1] - r0,
                                               t[2] - c0:t[3] - c0]
        return out
    out = _resize_rows(x, out_size, plan[:2])
    if plan[2] is not None:
        idx, wt = _lone_taps(x.shape[1], out_size, plan[2], x.device)
        out[-1:] = _lone_sum(_accumulate(x[-1:], idx, wt))
    if plan[3] is not None:
        out[:, -1:] = _resize_rows(x, out_size, ("chain", plan[3]),
                                   slice(out_size - 1, None))
    return out


def _resize_rows(x: torch.Tensor, out_size: int, plan: tuple,
                 cols: slice = slice(None)) -> torch.Tensor:
    """The output columns ``cols`` of x's resize summed by one plan."""
    idx, wt = _taps(x.shape[1], out_size, plan, x.device)
    idx, wt = idx[:, cols], wt[..., cols]
    a = _accumulate(x, idx, wt, {"chain": slice(0), "mul": slice(None),
                                 "lanes": slice(-1, None)}[plan[0]])
    if plan[0] != "lanes":             # the k-blocks, in order
        out = a[0]
        for blk in a[1:]:
            out = out + blk
        return out

    def lanes(b):                      # one block's lanes, pairwise
        if plan[1] == 4:
            return (a[b] + a[b + 1]) + (a[b + 2] + a[b + 3])
        return a[b] + a[b + 1]

    out = lanes(0)
    for b in range(plan[1], len(a) - 1, plan[1]):
        out = out + lanes(b)
    return out + a[-1]


# Image sizes whose 8-level, scale-1.2 pyramids tests/test_torch_frontend.py
# pins bit-exact against the reference (tests/torch_pyramid_probe.py):
# landscape, square and portrait sizes of the repo's sequences and of the
# common datasets. The resize takes every size (``resize_bilinear``); these
# are the ones the tests hold it to.
VERIFIED_SIZES = ((96, 128), (100, 200), (120, 160), (120, 300),
                  (200, 300), (240, 320), (240, 376), (256, 256),
                  (300, 400), (360, 640), (370, 1226), (375, 1242),
                  (376, 752), (376, 1241), (400, 640), (480, 480),
                  (480, 640), (480, 752), (480, 848), (512, 512),
                  (540, 960), (600, 800), (720, 1280), (768, 1024),
                  (800, 848), (1080, 1920), (752, 480), (640, 480),
                  (300, 120), (200, 100), (1241, 376), (848, 800))
# the System's frame resizes (Camera.newHeight/newWidth of a settings file;
# ``jax.image.resize(img, size, "linear")``) the tests pin the same way
RESIZE_STEPS = (((480, 752), (240, 376)), ((480, 752), (200, 320)),
                ((480, 752), (240, 320)), ((480, 752), (300, 500)),
                ((480, 752), (360, 564)), ((480, 752), (120, 188)))


@functools.lru_cache(maxsize=256)
def _refused(h: int, w: int, c: int, d: int,
             threads: int = REFERENCE_THREADS) -> str:
    """The classes of resize steps whose order is not reproduced (ROADMAP
    C3), as a reason, or "" for a step the port reproduces: a side of the
    image or of the result of one pixel (XLA turns a dot with a side of one
    into a vector product and reduces it), and an Eigen pass where one
    output's taps meet three or more of its k shards (a pass shrinking by a
    factor of about 30 or more: Eigen adds the shards' partial sums in a
    tree the port does not restate)."""
    if 1 in (h, w, c, d):
        return "a side of one pixel"
    if c != h and d != w and c * w * (h + d) > h * d * (w + c):
        passes = ((w, d, h), (h, c, d))
    else:
        passes = ((h, c, w),) if c != h else ()
    if any(_over_three_shards(k, out, other, threads)
           for k, out, other in passes):
        return "an output's taps over three of Eigen's k shards"
    return ""


def _over_three_shards(k: int, out: int, other: int, threads: int) -> bool:
    """Whether an output of this Eigen pass has taps in three k shards."""
    shards = _eigen_blocks(k, out, other, threads)[3]
    _, idx, ok = _tap_table(k, out)
    span = (np.searchsorted(shards, np.where(ok, idx, 0).max(0), "right")
            - np.searchsorted(shards, idx[0], "right"))
    return bool(span.max() >= 2)


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]
                    ) -> torch.Tensor:
    """``jax.image.resize(img, shape, "bilinear")`` for a 2-D image, with
    the bits of the reference's compiled resize in the regime it runs in
    here (``REFERENCE_THREADS``), at any image size. Raises for the steps
    whose order is not reproduced, a side of one pixel or a shrink of about
    30 times in one pass (``_refused``), rather than return other bits."""
    return _resize(img, shape, REFERENCE_THREADS)


def _resize(img: torch.Tensor, shape: Tuple[int, int], threads: int
            ) -> torch.Tensor:
    """The resize as the reference computes it on a pool of ``threads``
    (the probe holds other counts to the reference pinned to that many
    CPUs). Like ``jax.image.resize`` it contracts the axis that makes the
    cheaper einsum first: the height on landscape and square steps, the
    width, as a dot with both operands transposed, on portrait ones."""
    (h, w), (c, d) = img.shape, (int(shape[0]), int(shape[1]))
    out = img
    if (c, d) == (h, w):
        return out.contiguous()
    why = _refused(h, w, c, d, threads)
    if why:
        raise NotImplementedError(
            f"resize {h}x{w} -> {c}x{d}: {why}; its bits are not reproduced "
            f"(ROADMAP C3)")
    if c != h and d != w and c * w * (h + d) > h * d * (w + c):
        out = _resize_pass(out, d, "e", threads)          # (h, d)
        return _resize_pass(out.T, c, "e", threads).T.contiguous()
    if c != h:
        out = _resize_pass(out.T, c, "e", threads).T
    if d != w:
        out = _resize_pass(out, d, "w", threads)
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
