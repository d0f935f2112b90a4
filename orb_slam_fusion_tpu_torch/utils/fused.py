"""float32 arithmetic rounded as the reference's compiled programs round it.

Inside a jitted program XLA:CPU contracts a product and a sum into one
fused multiply-add. ``jnp.sum(x ** 2, axis=-1)`` over a short axis becomes
a chain of them, ``fma(x1, x1, x0 * x0)`` for two terms and one more fused
step per further term (``sum_sq_f32``); a small dot (``jnp.einsum`` over an
axis of 3 or 4, as in the two-view triangulation) becomes one chain per
output, the first product fused onto +0 (``contract_f32``). Eager PyTorch
rounds each product and each add. Where such a sum meets a threshold (a
pixel window, a chi-square gate) or feeds an ill-conditioned solve, the two
roundings part (ROADMAP C11, C14a).

A row-major matrix-vector product that XLA:CPU emits as its tiled gemv
(``gemv_f32``) sums each row in vector lanes of eight, then across the
lanes pairwise, in one pattern for rows in whole tiles of eight and in
another for the rows left over.

A dot that XLA:CPU fuses into a loop (``loop_dot_f32``) is one reduction
that LLVM vectorizes; a larger product it hands to Eigen, whose AVX-512
kernel keeps four interleaved chains over the contracted axis
(``gemm4_f32``).

``solve3_f32`` restates the 3x3 solve those programs call (LAPACK's
``sgetrf`` and two ``strsm`` through scipy's OpenBLAS) in the order of
OpenBLAS's SkylakeX kernels.

A reduction over more than 32 elements XLA:CPU splits into windows of 32
(``window_sum_f32``). ``delta / sqrt(x)`` it compiles as a multiply by
its own ``rsqrt``: the processor's estimate refined by one Newton step
(``rsqrt_f32``, with the estimate table of the AMD Zen 5 host that runs
the parity tests).

Everything here is elementwise IEEE float32 and float64 arithmetic and
table lookups, so the CPU and the card give the same bits. On CUDA float32
tensors ``fma_f32`` and ``contract_f32`` are one launch each of the
``libm`` kernel (``utils/libm.py``, ``csrc/libm.cu``), which rounds the
same way; ``fma_f32_plain`` and ``contract_f32_plain`` are their
elementwise versions.
"""

from __future__ import annotations

import base64
import functools
import zlib

import numpy as np
import torch


def fma_f32(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``x * y + acc`` rounded once, as a fused multiply-add:
    ``fma_f32_plain`` on the CPU, one launch of ``csrc/libm.cu`` on CUDA.
    Broadcasts its arguments. A float64 argument (a solver run in double
    precision for comparison) gets the plain ``x * y + acc``."""
    if torch.float64 in (x.dtype, y.dtype, acc.dtype):
        return x * y + acc
    if x.device.type == "cuda":
        from .libm import fma
        return fma(x, y, acc)
    return fma_f32_plain(x, y, acc)


def fma_f32_plain(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor
                  ) -> torch.Tensor:
    """float32 ``x * y + acc`` rounded once, in elementwise float64 steps.

    The product is exact in float64, and so is the error ``e`` of the
    float64 sum ``s`` (TwoSum). Rounding ``s`` to float32 is then right
    except where ``s`` lies exactly halfway between two float32 values
    and ``e`` points away from the one it rounded to: there the answer is
    the other one, ``r + 2 (s - r)``. ``s`` is such a midpoint exactly
    when that value is itself a float32. Broadcasts its arguments. A
    float64 argument (a solver run in double precision for comparison)
    gets the plain ``x * y + acc``."""
    if torch.float64 in (x.dtype, y.dtype, acc.dtype):
        return x * y + acc
    a = x.double() * y.double()
    b = acc.double()
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    r = s.float()
    r64 = r.double()
    d = s - r64                           # exact: the bits r dropped
    other = r64 + 2.0 * d
    fix = (other.float().double() == other) & (d * e > 0)
    return torch.where(fix, other.float(), r)


def sq_add_f32(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``x * x + acc`` rounded once (``fma_f32(x, x, acc)``)."""
    return fma_f32(x, x, acc)


def contract_f32(x: torch.Tensor, y: torch.Tensor,
                 zero: torch.Tensor | None = None) -> torch.Tensor:
    """``sum(x * y, dim=-1)`` over a short last axis as XLA:CPU emits a
    small dot: one chain of fused multiply-adds, element 0 first, from a
    zero accumulator (+0 by default). ``x`` and ``y`` broadcast. The first
    step, a product fused onto a zero, is the rounded product plus that
    zero; a ``zero`` of -0 keeps a product's -0 (a column-major
    matrix-vector kernel's first step is a plain multiply). On CUDA
    float32 tensors the whole chain is one launch of ``csrc/libm.cu``."""
    if (x.device.type == "cuda" and x.dtype == y.dtype == torch.float32
            and (zero is None or zero.dtype == torch.float32)):
        from . import libm
        if libm.plain_tensors(x, y, *(() if zero is None else (zero,))):
            return libm.contract_cuda(x, y, zero)
    # the CPU, or CUDA under a torch.func transform: a chain of steps
    return _contract_chain(x, y, zero, fma_f32)


def contract_f32_plain(x: torch.Tensor, y: torch.Tensor,
                       zero: torch.Tensor | None = None) -> torch.Tensor:
    """``contract_f32`` in elementwise steps on any device (the plain
    version of the kernel's ``contract``)."""
    return _contract_chain(x, y, zero, fma_f32_plain)


def _contract_chain(x, y, zero, fma):
    acc = x[..., 0] * y[..., 0]
    acc = acc + (0.0 if zero is None else zero)
    for k in range(1, x.shape[-1]):
        acc = fma(x[..., k], y[..., k], acc)
    return acc


GEMV_TILE = 8    # rows per tile and floats per vector of that gemv


def _halve(lanes: torch.Tensor) -> torch.Tensor:
    """The lanes of a vector (..., 8) added in halves, as LLVM reduces a
    vector: (0+4)+(2+6) and (1+5)+(3+7), then the two."""
    while lanes.shape[-1] > 1:
        n = lanes.shape[-1] // 2
        lanes = lanes[..., :n] + lanes[..., n:]
    return lanes[..., 0]


def gemv_f32(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for float32 (..., m, k) and (..., k) as XLA:CPU's tiled
    row-major gemv computes it (``lax.dot_general`` of a batched matrix and
    vector on the CPU). Each row keeps eight lanes, lane ``l`` a chain of
    fused steps over the columns ``l, l + 8, ...`` of the whole vectors;
    the lanes of a row in a whole tile of eight rows are then added in
    adjacent pairs, (0+1)+(2+3) and (4+5)+(6+7), those of a row left over
    in halves, (0+4)+(2+6) and (1+5)+(3+7); the columns past the last
    whole vector make a chain of their own, added last."""
    m, k = A.shape[-2:]
    w = GEMV_TILE
    kv = k // w * w
    out = None
    if kv:
        lanes = A[..., :w] * x[..., None, :w]
        for c in range(w, kv, w):
            lanes = fma_f32(A[..., c:c + w], x[..., None, c:c + w], lanes)
        pairs = lanes
        while pairs.shape[-1] > 1:
            pairs = pairs[..., 0::2] + pairs[..., 1::2]
        whole = torch.arange(m, device=A.device) < m // w * w
        out = torch.where(whole, pairs[..., 0], _halve(lanes))
    if kv < k:
        rest = contract_f32(A[..., kv:], x[..., None, kv:])
        out = rest if out is None else out + rest
    return out


def loop_dot_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum(x * y, dim=-1)`` as XLA:CPU computes a dot fused into a loop
    (``lax.dot_general`` inside a fusion): LLVM vectorizes the reduction
    into two accumulators of eight lanes over the whole blocks of sixteen
    elements (fused chains), adds them and halves the lanes; the next
    eight elements, if whole, make one more vector whose lane 0 carries
    that sum (fused onto it), halved in turn; the rest is a fused chain
    onto the total. This is the loop of the inertial init's gradient at the
    sessions' sizes (252 elements); a loop short enough for LLVM to unroll
    (81 elements) is summed in another order, not restated here."""
    k = x.shape[-1]
    w = GEMV_TILE
    main = k // (2 * w) * (2 * w)
    out = None
    if main:
        a0 = x[..., :w] * y[..., :w]
        a1 = x[..., w:2 * w] * y[..., w:2 * w]
        for c in range(2 * w, main, 2 * w):
            a0 = fma_f32(x[..., c:c + w], y[..., c:c + w], a0)
            a1 = fma_f32(x[..., c + w:c + 2 * w], y[..., c + w:c + 2 * w],
                         a1)
        out = _halve(a1 + a0)
    c = main
    if k - c >= w:
        lanes = x[..., c:c + w] * y[..., c:c + w]
        if out is not None:
            lanes = torch.cat([fma_f32(x[..., c], y[..., c], out)[..., None],
                               lanes[..., 1:]], dim=-1)
        out = _halve(lanes)
        c += w
    for c in range(c, k):
        out = x[..., c] * y[..., c] if out is None else \
            fma_f32(x[..., c], y[..., c], out)
    return out


def gemm4_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y.T`` for float32 (n, k) and (m, k), as the Eigen contraction
    that XLA:CPU calls for a larger dot computes it on an AVX-512 host:
    each entry keeps four chains of fused steps over the contracted axis,
    chain ``c`` over the elements ``c, c + 4, ...``, then adds them as
    (0+1)+(2+3). The chains advance four elements a step, one batched
    operation for every entry. This is Eigen's order for the inertial
    init's 99 x 252 x 99 product of the sessions; a smaller product (39 x
    81 x 39) and the full VI-BA's deep ones (16,384 and 18,432 terms, which
    Eigen splits among its threads) are summed in other orders."""
    k = x.shape[-1]
    xs, ys = x[:, None, :], y[None, :, :]
    acc = xs[..., :4] * ys[..., :4]
    for c in range(4, k, 4):
        n = min(4, k - c)
        step = fma_f32(xs[..., c:c + n], ys[..., c:c + n], acc[..., :n])
        acc = step if n == 4 else torch.cat([step, acc[..., n:]], dim=-1)
    if acc.shape[-1] < 4:
        acc = torch.cat([acc, torch.zeros_like(acc[..., :4 - acc.shape[-1]])],
                        dim=-1)
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def _swap(p: torch.Tensor, i: int) -> torch.Tensor:
    """The row order (..., 3) that swaps row ``i`` with row ``p`` (>= i)."""
    idx = torch.arange(3, device=p.device).expand(p.shape + (3,))
    pe = p.unsqueeze(-1)
    return torch.where(idx == i, pe, torch.where(idx == pe, i, idx))


def solve3_f32(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.solve(A, b)`` for float32 3x3 systems (..., 3, 3) and
    (..., 3), bit for bit as the reference computes it on the CPU:
    OpenBLAS's ``sgetrf`` (its left-looking ``getf2``: partial pivoting on
    the first largest magnitude, a column scaled by the pivot's float32
    reciprocal, the updates of columns 1 and 2 as ``dot``/``gemv``
    products each rounded before its subtraction, the last one a fused
    chain), then ``strsm`` with a unit lower and an upper factor (the
    diagonal's reciprocals, the lower solve's and the upper solve's
    in-block updates fused). This is the order of OpenBLAS's SkylakeX
    kernels, which scipy loads on an AVX-512 host; its Haswell kernels
    round the gemv chain and both in-block updates apart (ROADMAP C14a).
    A zero pivot scales nothing, and its reciprocal (inf) carries into
    the solution as in LAPACK."""
    one = torch.ones((), dtype=A.dtype, device=A.device)
    p0 = _swap(torch.argmax(torch.abs(A[..., :, 0]), dim=-1), 0)
    A = A.gather(-2, p0.unsqueeze(-1).expand(A.shape))
    b = b.gather(-1, p0)
    u00 = A[..., 0, 0]
    r00 = one / u00
    lc = torch.where((u00 != 0).unsqueeze(-1),
                     A[..., 1:, 0] * r00.unsqueeze(-1), A[..., 1:, 0])
    u01 = A[..., 0, 1]
    t = A[..., 1:, 1] - lc * u01[..., None]              # column 1 rows 1-2
    sw = torch.abs(t[..., 1]) > torch.abs(t[..., 0])     # second pivot
    swp = sw.unsqueeze(-1)
    lc = torch.where(swp, lc.flip(-1), lc)
    t = torch.where(swp, t.flip(-1), t)
    p1 = _swap(sw.long() + 1, 1)
    c2 = A[..., :, 2].gather(-1, p1)
    b = b.gather(-1, p1)
    u11 = t[..., 0]
    r11 = one / u11
    l21 = torch.where(u11 != 0, t[..., 1] * r11, t[..., 1])
    l10, l20 = lc[..., 0], lc[..., 1]
    u02 = c2[..., 0]
    u12 = c2[..., 1] - l10 * u02
    # forward: unit lower; the block of rows 0-1 solves in place (fused),
    # row 2 takes one gemm update (a fused chain, subtracted), which is
    # the chain of u22 on the right-hand side: both in one step
    y0 = b[..., 0]
    y1 = fma_f32(-y0, l10, b[..., 1])
    ch = fma_f32(l21.unsqueeze(-1), torch.stack([u12, y1], dim=-1),
                 l20.unsqueeze(-1) * torch.stack([u02, y0], dim=-1))
    u22 = c2[..., 2] - ch[..., 0]
    y2 = b[..., 2] - ch[..., 1]
    # backward: row 2 alone, then rows 0-1 after one rounded gemm update
    x2 = y2 * (one / u22)
    c = torch.stack([y0, y1], dim=-1) - torch.stack([u02, u12], dim=-1) \
        * x2[..., None]
    x1 = c[..., 1] * r11
    x0 = fma_f32(-x1, u01, c[..., 0]) * r00
    return torch.stack([x0, x1, x2], dim=-1)


def within_fused(du: torch.Tensor, dv: torch.Tensor, r2: torch.Tensor
                 ) -> torch.Tensor:
    """``fma(dv, dv, du*du) <= r2``, the window test of the reference's
    jitted programs. The term-by-term sum differs from it by an ulp or two,
    so only the pairs within 1e-6 of the edge are decided by the fused
    value, the rest as they are."""
    d2 = du * du + dv * dv
    ok = d2 <= r2
    near = (d2 <= r2 * (1.0 + 1e-6) + 1e-30) & \
        (d2 >= r2 * (1.0 - 1e-6) - 1e-30)
    i = torch.nonzero(near, as_tuple=True)
    r2 = r2.expand_as(d2)
    return ok.index_put(i, sq_add_f32(dv[i], du[i] * du[i]) <= r2[i])


def sum_sq_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sum(x ** 2, dim=-1)`` as XLA:CPU fuses it: the first
    square rounded, then one fused multiply-add per further element."""
    out = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        out = sq_add_f32(x[..., i], out)
    return out


WINDOW = 32      # XLA:CPU's tree-reduction window


def window_sum_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.sum(dim)`` for float32 as XLA:CPU compiles a reduction over more
    than 32 elements: it pads the axis with zeros to a multiple of 32 (half
    the padding in front, the odd one behind), sums each window of 32 in
    order from +0, and reduces the window sums the same way until 32 or
    fewer remain, which it adds in order from +0."""
    x = x.movedim(dim, 0)
    while x.shape[0] > WINDOW:
        n = x.shape[0]
        pad = -n % WINDOW
        if pad:
            z = torch.zeros((1,) + x.shape[1:], dtype=x.dtype,
                            device=x.device)
            x = torch.cat([z.expand((pad // 2,) + x.shape[1:]), x,
                           z.expand((pad - pad // 2,) + x.shape[1:])])
        x = x.reshape((-1, WINDOW) + x.shape[1:]).movedim(1, 0)
        acc = x[0] + 0.0
        for j in range(1, WINDOW):
            acc = acc + x[j]
        x = acc
    acc = x[0] + 0.0
    for j in range(1, x.shape[0]):
        acc = acc + x[j]
    return acc


# The reciprocal square-root estimate of the AMD Zen 5 host (its
# ``vrsqrtss``): 12 significant bits, read off the top 12 bits of the
# input's mantissa and its exponent's parity. Per parity (even, then odd)
# the first code, then the steps down from one entry to the next (0-2),
# zlib-compressed; entry ``j`` of a parity is the estimate at 1 + j/4096
# (even) or 2 + j/2048 (odd), a float in [0.5, 1) with that code as the
# top 12 bits of its mantissa.
_RSQRT_FIRST = (4095, 1696)
_RSQRT_STEPS = (
    "eNrdlgkOwzAIBBf+/+hKvRx8UQrGbptGZLKDI1mRAtH9h0chpjkT+Xxy+l5GJ7/e"
    "44n7Sb67wp6jXKNhVvLVjGC/n4udEcxKvpoR7Nc5F7r+h2z1dzM0v5jdujrH4n61"
    "Pq/l/nzPCPaj846PpkyYjX42w+qTPEhhHJa7ffzXgW/7qv2og1Fu9bNz1bc0d5ic"
    "/bv5jfV2DBhGP3q9aB/izuv9KJyd7/CNLS7Ofp7OMvPW09bT+02DNSs5ggd5BPtN"
    "Lkbi8oUYMRt9K2Nx/yh/FTaOnnzwKGxj8UW8hlNGcJ7t48/GWVhzZZDw5l4/ur/h"
    "zWMokvsnfmccXJ9n+21/4KzyAxVoX3w5F84ZRt/aj+T1cNh6Xt+8XuDav8h1hsXP"
    "RnJ/tJ+9XnTe+s/rwanl2f5p/ac/Tztv4CUP/w==")


@functools.lru_cache(maxsize=None)
def _rsqrt_table(device: str) -> torch.Tensor:
    """The estimates' float32 bit patterns (8192,) int32, on ``device``."""
    steps = np.frombuffer(zlib.decompress(base64.b64decode(_RSQRT_STEPS)),
                          np.uint8).astype(np.int64).reshape(2, -1)
    codes = [first - np.concatenate([[0], np.cumsum(s)])
             for first, s in zip(_RSQRT_FIRST, steps)]
    bits = (126 << 23) | (np.concatenate(codes) << 11)
    return torch.from_numpy(bits.astype(np.int32)).to(device)


def rsqrt_est_f32(x: torch.Tensor) -> torch.Tensor:
    """The host's ``vrsqrtss`` estimate of 1/sqrt(x) for positive normal
    float32 ``x``: the table entry of its mantissa's top 12 bits and its
    exponent's parity, scaled by the power of two that the exponent's
    half gives."""
    b = x.contiguous().view(torch.int32)
    e = ((b >> 23) & 0xff) - 127
    idx = ((b >> 11) & 0xfff) + (e & 1) * 4096
    half = torch.div(e, 2, rounding_mode="floor")
    return (_rsqrt_table(str(x.device))[idx.long()] - half * (1 << 23)).view(
        torch.float32)


def rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """``lax.rsqrt`` for float32 as XLA:CPU compiles it on the AMD Zen 5
    host: the estimate ``r`` (``rsqrt_est_f32``) and one Newton step,
    ``fma(-0.5 r, fma(r, x r, -1), r)``; at +inf the estimate (0), at NaN
    NaN. ``x`` must be at least the smallest normal float32 (the callers
    clamp it to 1e-12)."""
    est = rsqrt_est_f32(x)
    t = fma_f32(est, x * est, torch.full_like(est, -1.0))
    y = fma_f32(-0.5 * est, t, est)
    y = torch.where(torch.isinf(x), torch.zeros_like(y), y)
    return torch.where(torch.isnan(x), x, y)
