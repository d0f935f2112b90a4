"""Image pyramid and Gaussian blur.

Counterpart of ``orb_slam_fusion_tpu/frontend/pyramid.py``. The reference
downscales with ``jax.image.resize(..., "bilinear")``, which antialiases
when it shrinks: a triangle filter as wide as the scale step, applied as
one dot product per axis. ``F.interpolate`` computes other weights, so the
port rebuilds the resize, rounded as the reference's CPU build (jax 0.9,
XLA:CPU) rounds it, so that the levels come out bit for bit the same:

* the weights (``resize_weights``) follow XLA's two loop fusions: columns
  in the vectorised part round the sample position as an FMA and the tent
  as multiply-then-subtract; columns XLA unrolls or leaves to the scalar
  remainder round the other way round. The column totals are summed in
  windows of 32 rows, as XLA's tree reduction does;
* the axes go in ``jax.image.resize``'s einsum order: the height first,
  unless contracting the width first is cheaper (portrait steps), and
  then both dots have both operands transposed;
* each output pixel sums only its non-zero taps (``_taps``) in the order
  of the dot XLA's CPU runtime runs (``_dot_plan``). The width pass of a
  height-first step is XLA's own dot: fused multiply-add chains in
  k-blocks of 512, or 2 or 4 interleaved chains summed pairwise. Every
  other pass is an Eigen tensor contraction on XLA's intra-op thread pool,
  which cuts the contracted axis into blocks by a cost model of the shape
  and of the pool's size (``_eigen_blocks``), and sums one row apart in
  8 lanes when its last row block is one row wide (``_lone_taps``).

So the reference's bits depend on the thread count: XLA sizes its pool to
the larger of the host devices and the CPUs the process may run on. The
port reproduces the regime the reference runs in under tests/conftest.py
and the goldens, 8 host devices (``REFERENCE_THREADS``); ``resize_bilinear``
takes the count as an argument, and tests/torch_pyramid_probe.py --cpus N
holds it to the reference pinned to N CPUs. The probe's 31 sizes (landscape,
square and portrait) and a seeded sweep are pinned bit-exact by
tests/test_torch_frontend.py. Two classes of steps are not reproduced yet
and raise rather than return other bits (``_refused``, ROADMAP C3): an
axis resized from fewer than 32 pixels, and the width pass of a
height-first step with fewer than 51 rows and a weight panel over 128 KiB.

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
    into ``out`` outputs over ``other`` rows, and the m block sizes its
    kernel calls see: ([(start, end)], [mc])."""
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
            blocks, mcs = [], []
            for s in range(0, k, size):
                e = min(k, s + size)
                kc, mc, _ = _blocking(e - s, m, n, shards)
                blocks += [(a, min(e, a + kc)) for a in range(s, e, kc)]
                mcs.append(mc)
            return blocks, mcs
        if nt > 1:
            kc, mc, _ = _blocking(k, m, n, nt, _shard_by_col(m, n, nt))
            return [(a, min(k, a + kc)) for a in range(0, k, kc)], [mc]
    kc, mc, _ = _blocking_single(k, m, n)
    return [(a, min(k, a + kc)) for a in range(0, k, kc)], [mc]


def _split_long(s: int, e: int) -> List[int]:
    """The kernel's own cut of a k block longer than 384: in halves."""
    if e - s <= 384:
        return []
    h = s + _divup(e - s, 2)
    return _split_long(s, h) + [h] + _split_long(h, e)


@functools.lru_cache(maxsize=512)
def _dot_plan(kind: str, k: int, out: int, other: int,
              threads: int = REFERENCE_THREADS):
    """How the reference's CPU dot sums over the contracted axis k for one
    resize pass of ``other`` rows into ``out`` outputs.

    Kind "w", the width pass of a height-first resize, is XLA's own tiled
    dot, the same on any thread count: ``("chain", block_starts)`` or
    ``("lanes", lanes, main, block_starts)``; in the lanes plan each k-block
    of 1024 has its own lanes, summed pairwise, and the blocks are added in
    order. Kind "e" is every other pass (Eigen, see ``_eigen_blocks``):
    ``("chain", block_starts, lone)``, where ``lone`` is None, or, when the
    kernel's last m block is one row wide, the Eigen block starts that
    row (the pass's last ``other`` row) is summed over in 8 lanes
    (``_lone_taps``)."""
    if kind == "w":
        if (other >= 51 and (out - 1) % 64 < 48) or (out == 16 and other > 1):
            lanes = 4 if (out - 1) % 32 < 16 else 2
            return ("lanes", lanes, k - k % lanes, tuple(range(0, k, 1024)))
        return ("chain", tuple(range(0, k, 512)))
    blocks, mcs = _eigen_blocks(k, out, other, threads)
    starts = []
    for s, e in blocks:
        starts += [s] + _split_long(s, e)
    lone = None
    if any(other % mc == 1 or other == 1 for mc in mcs):
        lone = tuple(s for s, _ in blocks)
    return ("chain", tuple(starts), lone)


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
    For a chain, c counts k-blocks from the column's first one; for lanes,
    c is the lane plus ``lanes`` times that block count (a column's taps
    straddle at most one block edge), and c = 2 * lanes the remainder."""
    w, idx, ok = _tap_table(in_size, out_size)
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
    return _weights(w, idx, ok, acc, n_acc, device)


@functools.lru_cache(maxsize=64)
def _lone_taps(in_size: int, out_size: int, starts: tuple,
               device: torch.device):
    """The taps of the pass's last row where the kernel sums it alone: per
    Eigen k block (``starts``), 8 lanes of fused multiply-adds over k
    (relative to the block's start) on its largest multiple of 8, then the
    rest as rounded products in groups of 4, 2 and 1. Accumulators: 15 per
    block (8 lanes, 4, 2, 1), counted from the output's first block; a
    window of taps meets at most two blocks."""
    w, idx, ok = _tap_table(in_size, out_size)
    st = np.asarray(starts)
    ends = np.append(st[1:], in_size)
    block = np.searchsorted(st, idx, side="right") - 1
    rel = idx - st[block]
    length = (ends - st)[block]
    main = length - length % 8
    r = rel - main                      # position within the tail
    rest = length % 8
    slot = np.where(rel < main, rel % 8,
                    np.where(r < (rest & 4), 8 + r,
                             np.where(r < (rest & 4) + (rest & 2),
                                      12 + r - (rest & 4), 14)))
    acc = (block - block[0]) * 15 + slot
    return _weights(w, idx, ok, acc, 30, device)


def _accumulate(x: torch.Tensor, idx: torch.Tensor, wt: torch.Tensor,
                round_last: bool = False) -> Tuple[torch.Tensor, ...]:
    """Each accumulator's fused multiply-add chain over the taps (a float32
    product is exact in float64, so (p + c) in float64 rounded to float32
    stands for a fused multiply-add): (R, out) tensors, one per
    accumulator. With ``round_last`` the last accumulator multiplies, then
    adds (the lanes plan's remainder)."""
    prods = x.double()[:, idx].unsqueeze(2) * wt       # (R, T, C, out)
    if round_last:
        prods[:, :, -1] = prods[:, :, -1].float()
    acc = torch.zeros(prods[:, 0].shape, dtype=torch.float32,
                      device=x.device)
    for t in range(idx.shape[0]):      # one fused multiply-add per tap
        torch.add(prods[:, t], acc, out=acc)
    return acc.unbind(1)


def _lone_sum(a) -> torch.Tensor:
    """Combine ``_lone_taps``' accumulators as the kernel does: per block
    ((l0+l1)+(l4+l5))+((l2+l3)+(l6+l7)), then the group of 4 summed
    pairwise, then the pair, then the single; the blocks in order."""
    def block(b):
        l = a[b:b + 15]
        out = ((l[0] + l[1]) + (l[4] + l[5])) + ((l[2] + l[3]) + (l[6] + l[7]))
        out = out + ((l[8] + l[9]) + (l[10] + l[11]))
        return (out + (l[12] + l[13])) + l[14]
    return block(0) + block(15)


def _resize_pass(x: torch.Tensor, out_size: int, kind: str,
                 threads: int = REFERENCE_THREADS) -> torch.Tensor:
    """Resize the last axis of x (R, in) to (R, out_size), summing each
    output's taps in the reference dot's order (``_dot_plan``)."""
    plan = _dot_plan(kind, x.shape[1], out_size, x.shape[0], threads)
    if kind == "e" and plan[2] is not None:
        head = _resize_rows(x[:-1], out_size, plan[:2])
        idx, wt = _lone_taps(x.shape[1], out_size, plan[2], x.device)
        return torch.cat([head, _lone_sum(_accumulate(x[-1:], idx, wt))])
    return _resize_rows(x, out_size, plan[:2] if kind == "e" else plan)


def _resize_rows(x: torch.Tensor, out_size: int, plan: tuple
                 ) -> torch.Tensor:
    idx, wt = _taps(x.shape[1], out_size, plan, x.device)
    a = _accumulate(x, idx, wt, round_last=plan[0] == "lanes")
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


def _refused(h: int, w: int, c: int, d: int) -> str:
    """The classes of resize steps whose order is not reproduced (ROADMAP
    C3), as a reason, or "" for a step the port reproduces."""
    if (c != h and h < 32) or (d != w and w < 32):
        return "an axis resized from fewer than 32 pixels"
    height_first = not (c != h and d != w and c * w * (h + d) > h * d * (w + c))
    if height_first and d != w and c < 51 and not (d == 16 and c > 1) \
            and w * d * 4 > 128 * 1024:
        return ("a width pass of fewer than 51 rows with a weight panel "
                "over 128 KiB")
    return ""


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]
                    ) -> torch.Tensor:
    """``jax.image.resize(img, shape, "bilinear")`` for a 2-D image, with
    the bits of the reference's compiled resize in the regime it runs in
    here (``REFERENCE_THREADS``). Raises for a step of a class whose order
    is not reproduced (``_refused``) rather than return other bits."""
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
    why = _refused(h, w, c, d)
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
