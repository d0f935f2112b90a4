"""float32 sin, cos, tan, atan2, exp and log with the reference's bits.

The reference's programs (XLA:CPU of jax 0.9.0 on the AMD Zen 5 host that
runs the parity tests; read off their optimized LLVM IR and object code with
``XLA_FLAGS=--xla_dump_to``) compute these functions so, whether a call runs
eagerly or inside a jitted program:

* ``sin``, ``cos``: a call to glibc 2.36's ``sinf``/``cosf``. Its IFUNC
  picks the build for a host with FMA and AVX2 (``__sinf_fma``): a pi/2
  reduction and polynomials in double precision, every ``a + b * c`` one
  fused multiply-add (``_fma64``), rounded once to float32 at the end.
* ``tan``: a call to glibc's ``tanf`` (one build for every host): the same
  reduction without fused steps, then fdlibm's float32 ``__kernel_tanf``,
  one rounding per operation.
* ``atan2``: a call to glibc's ``atan2f`` (fdlibm), one rounding per
  operation.
* ``exp``, ``log``: XLA:CPU's own inlined polynomials (Cephes' ``expf`` and
  ``logf``), which LLVM compiles for the Zen 5 host with fused
  multiply-adds (``fma_f32``) at the steps marked below.

All of them run with flush-to-zero and denormals-are-zero on (``_flush``).

Each twin here (``*_plain``) restates one of them with elementwise IEEE
float32/float64 operations, integer bit operations and table lookups, so it
gives the same bits on the CPU and on the card. The public functions
(``sin``, ``cos``, ``tan``, ``atan2``, ``exp``, ``log``) run the twin on a
CPU tensor and launch the hand-written kernel ``csrc/libm.cu`` on a CUDA
tensor (no fallback: a failed build or launch raises). They are
``torch.autograd.Function``s with JAX's forward-mode rules and a ``vmap``
rule, so ``torch.func.jacfwd`` differentiates through them. A float64
argument (a solver run in double precision for comparison; the reference
has no float64 path) takes the library function.

``fma``/``contract`` launch the same kernel for ``utils/fused.py``'s
``fma_f32`` and ``contract_f32`` on CUDA float32 tensors, and
``octave_pow`` for the pyramid's ``1.2 ** octave`` (glibc's ``powf`` at
integer exponents, a table).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

launches = 0                  # launches of the kernel, all functions
launches_by_fn: dict = {}     # the same by function name

FUNCS = ("tan", "exp", "log", "sin", "cos", "atan2", "fma", "contract",
         "octave_pow")
_FID = {name: i for i, name in enumerate(FUNCS)}
MAX_DIMS = 6                  # broadcast dimensions the kernel indexes


def _w32(*words: int):
    """float32 values of bit patterns, as Python floats."""
    return [float(np.array(w, np.uint32).view(np.float32)) for w in words]


def _h64(*hexes: str):
    return [float.fromhex(h) for h in hexes]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32).view(torch.float32)


def _quiet(x: torch.Tensor) -> torch.Tensor:
    """A NaN's bits with the quiet bit set, as x86 propagates a NaN
    operand through arithmetic."""
    return _from_bits(_bits(x) | 0x00400000)


_DEFAULT_NAN = -4194304       # 0xffc00000: x86's NaN of an invalid operation


def _flush(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with subnormals replaced by zeros of their sign. The
    reference's programs run with the processor's flush-to-zero and
    denormals-are-zero modes on (XLA:CPU sets them on its threads, glibc's
    functions included): a subnormal operand reads as zero, a subnormal
    result is written as zero."""
    b = _bits(x)
    return _from_bits(torch.where((b & 0x7F800000) == 0, b & -2147483648, b))


# ---------------------------------------------------------------------------
# float64 fused multiply-add
# ---------------------------------------------------------------------------


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """``a * b = p + e`` exactly (Dekker, Veltkamp's split)."""
    p = a * b
    t = a * 134217729.0
    ah = t - (t - a)
    al = a - ah
    t = b * 134217729.0
    bh = t - (t - b)
    bl = b - bh
    e = al * bl - (((p - ah * bh) - al * bh) - ah * bl)
    return p, e


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _add_odd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` rounded to odd: the rounded sum, or where it is inexact
    and its last bit even, its neighbour towards the exact sum."""
    s, e = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.where(e > 0, math.inf, -math.inf)
                             .to(s.dtype))
    return torch.where((e != 0) & even, toward, s)


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """float64 ``a * b + c`` rounded once (Boldo and Melquiond's emulation:
    the exact product, an exact sum with ``c``, the two low parts added
    rounded to odd, then one rounding). Valid away from overflow and
    underflow, which the polynomials here never reach."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_odd(tl, ul)


# ---------------------------------------------------------------------------
# pi/2 reductions (glibc sysdeps/ieee754/flt-32/s_sincosf.h)
# ---------------------------------------------------------------------------

_HPI_INV, _HPI, _PI63 = _h64("0x1.45f306dc9c883p+23", "0x1.921fb54442d18p+0",
                             "0x1.921fb54442d18p-62")
# __inv_pio4: 4/pi in 32-bit words, read from glibc 2.36's libm
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)
_M32 = 0xFFFFFFFF


def _abstop12(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 20) & 0x7FF


def _reduce_fast_n(x: torch.Tensor) -> torch.Tensor:
    """The quadrant ``n`` of float64 ``x`` (|x| < 120): ``x * 2/pi * 2^24``
    truncated to int32, rounded at bit 24."""
    r = (x * _HPI_INV).trunc().to(torch.int32)
    return (r + 0x800000) >> 24


def _reduce_large(bits: torch.Tensor):
    """glibc's ``reduce_large`` of float32 bits (|x| >= 120, finite):
    (x mod pi/2 in float64, without the sign; quadrant n in 0..3). The
    64-bit wrap-around arithmetic runs on 32-bit halves held in int64."""
    b = bits.to(torch.int64) & _M32
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=bits.device)
    idx = (b >> 26) & 15
    m = ((b & 0x7FFFFF) | 0x800000) << ((b >> 23) & 7)
    r0 = (m * table[idx]) & _M32                     # uint32 product
    r1 = m * table[idx + 4]                          # < 2^63
    r2 = m * table[idx + 8]
    # res0 = ((r2 >> 32) | (r0 << 32)) + r1, modulo 2^64, as (hi, lo)
    lo = (r2 >> 32) + (r1 & _M32)
    hi = (r0 + (r1 >> 32) + (lo >> 32)) & _M32
    lo = lo & _M32
    n = ((hi + (1 << 29)) & _M32) >> 30              # (res0 + 2^61) >> 62
    hi = (hi - (n << 30)) & _M32                     # res0 -= n << 62
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    x = (hi * (1 << 32) + lo).to(torch.float64) * _PI63
    return x, n.to(torch.int32)


# ---------------------------------------------------------------------------
# sinf, cosf (glibc 2.36 s_sinf.c, s_cosf.c, built with FMA)
# ---------------------------------------------------------------------------

# __sincosf_table: c0, c1, s1, c2, s2, c3, s3, c4; the second table serves
# the quadrants with n & 2 (its c terms negated)
_SC0 = dict(c0=1.0, c1=float.fromhex("-0x1.ffffffd0c621cp-2"),
            s1=float.fromhex("-0x1.555545995a603p-3"),
            c2=float.fromhex("0x1.55553e1068f19p-5"),
            s2=float.fromhex("0x1.1107605230bc4p-7"),
            c3=float.fromhex("-0x1.6c087e89a359dp-10"),
            s3=float.fromhex("-0x1.994eb3774cf24p-13"),
            c4=float.fromhex("0x1.99343027bf8c3p-16"))
_SC1 = {k: -v if k.startswith("c") else v for k, v in _SC0.items()}


def _sincos_poly(x: torch.Tensor, x2: torch.Tensor, swap: torch.Tensor,
                 odd: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf_poly``: the sine polynomial of (signed) ``x`` where
    ``odd`` is False, the cosine one where True; table 1 where ``swap``."""
    sel = swap.long()

    def tab(key):
        return torch.tensor((_SC0[key], _SC1[key]), dtype=x.dtype,
                            device=x.device)[sel]

    # sine: x3 = x2 x, x7 = x2 x3, fma(fma(x2, s3, s2), x7, fma(x3, s1, x))
    x3 = x2 * x
    s1 = _fma64(x2, tab("s3"), tab("s2"))
    x7 = x2 * x3
    s = _fma64(x3, tab("s1"), x)
    sin = _fma64(s1, x7, s)
    # cosine: x4 = x2 x2, x6 = x2 x4, fma(c4 poly, x6, fma(x4, c2, c1 poly))
    x4 = x2 * x2
    c1 = _fma64(x2, tab("c1"), tab("c0"))
    c2 = _fma64(x2, tab("c4"), tab("c3"))
    x6 = x2 * x4
    c = _fma64(x4, tab("c2"), c1)
    cos = _fma64(c2, x6, c)
    return torch.where(odd, cos, sin)


_SIGN = (1.0, -1.0, -1.0, 1.0)


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    bits = _bits(y)
    top = _abstop12(bits)
    neg = bits < 0
    x = y.double()
    small = top < 0x3F4                               # |y| < pi/4 (roughly)
    medium = (top >= 0x3F4) & (top < 0x42F)           # |y| < 120
    large = (top >= 0x42F) & (top < 0x7F8)
    # |y| < 120: the fast reduction; x - n pi/2 is one fused step
    xm = torch.where(medium, x, torch.zeros_like(x))
    n_m = _reduce_fast_n(xm)
    xr_m = _fma64(-n_m.double(), torch.full_like(x, _HPI), xm)
    # larger: the 4/pi table; the sign enters the quadrant
    xl, n_l = _reduce_large(torch.where(large, bits, torch.zeros_like(bits)))
    q_l = n_l + neg.to(torch.int32)
    n = torch.where(medium, n_m, torch.where(large, n_l, 0))
    q = torch.where(medium, n_m, torch.where(large, q_l, 0))
    xr = torch.where(medium, xr_m, torch.where(large, xl, x))
    sign = torch.tensor(_SIGN, dtype=torch.float64, device=y.device)[
        (q & 3).long()]
    xs = torch.where(small, x, xr * sign)
    odd = ((n ^ int(cos)) & 1) == 1
    out = _sincos_poly(xs, xr * xr, (q & 2) != 0, odd).float()
    tiny = top < 0x398                                # |y| < 2^-12
    out = torch.where(tiny, torch.ones_like(y) if cos else y, out)
    nan = torch.where(torch.isnan(y), _quiet(y),
                      _from_bits(torch.full_like(bits, _DEFAULT_NAN)))
    return torch.where(top >= 0x7F8, nan, out)


def sinf_plain(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf`` (FMA build) of float32 ``y``."""
    return _sincosf(y, False)


def cosf_plain(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf`` (FMA build) of float32 ``y``."""
    return _sincosf(y, True)


# ---------------------------------------------------------------------------
# tanf (glibc 2.36 s_tanf.c, fdlibm k_tanf.c; no fused steps)
# ---------------------------------------------------------------------------

_PIO4, _PIO4LO = _w32(0x3F490FDA, 0x33222168)
# T[0..12]
_T = _w32(0x3EAAAAAB, 0x3E088889, 0x3D5D0DD1, 0x3CB327A4, 0x3C11371F,
          0x3B6B6916, 0x3ABEDE48, 0x3A1A26C8, 0x398137B9, 0x38A3F445,
          0x3895C07A, 0xB79BAE5F, 0x37D95384)


def _kernel_tanf(x: torch.Tensor, y: torch.Tensor, iy: torch.Tensor
                 ) -> torch.Tensor:
    """fdlibm's ``__kernel_tanf(x, y, iy)``: tan(x + y) for iy = 1,
    -1/tan(x + y) for iy = -1, |x + y| <~ pi/4."""
    one = torch.ones_like(x)
    hx = _bits(x)
    ix = hx & 0x7FFFFFFF
    sgn = torch.where(hx < 0, -1.0, 1.0).to(x.dtype)
    big = ix >= 0x3F2CA140                            # |x| >= 0.6744
    xb = torch.where(hx < 0, -x, x)
    yb = torch.where(hx < 0, -y, y)
    xb = (torch.full_like(x, _PIO4) - xb) + (torch.full_like(x, _PIO4LO)
                                             - yb)
    x_ = torch.where(big, xb, x)
    y_ = torch.where(big, torch.zeros_like(y), y)
    fiy = iy.to(x.dtype)
    near = big & (torch.abs(xb) < 2.0 ** -13)
    near_val = (sgn * fiy) * (one - (fiy + fiy) * xb)
    z = x_ * x_
    w = z * z
    r = torch.full_like(x, _T[11])
    for k in (9, 7, 5, 3, 1):
        r = r * w + _T[k]
    v = torch.full_like(x, _T[12])
    for k in (10, 8, 6, 4, 2):
        v = v * w + _T[k]
    v = v * z
    s = z * x_
    r = y_ + z * (s * (r + v) + y_)
    r = s * _T[0] + r
    w = x_ + r
    big_val = sgn * (fiy - (x_ - ((w * w) / (w + fiy) - r)) * 2.0)
    # iy = -1: -1/(x + r) with the quotient's error recovered
    a = -one / w
    zt = _from_bits(_bits(w) & -4096)                 # & 0xfffff000
    vt = r - (zt - x_)
    t = _from_bits(_bits(a) & -4096)
    sm = t * zt + 1.0
    inv_val = t + a * (t * vt + sm)
    out = torch.where(big, big_val, torch.where(iy == 1, w, inv_val))
    out = torch.where(near, near_val, out)
    tiny = ix < 0x39000000                            # |x| < 2^-13
    tiny_val = torch.where(
        iy == 1, x, torch.where(ix == 0, one / torch.abs(x), -one / x))
    return torch.where(tiny, tiny_val, out)


def tanf_plain(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``tanf`` of float32 ``x``."""
    bits = _bits(x)
    ix = bits & 0x7FFFFFFF
    top = _abstop12(bits)
    xd = x.double()
    medium = (ix > 0x3F490FDA) & (top < 0x42F)
    large = (top >= 0x42F) & (ix < 0x7F800000)
    xm = torch.where(medium, xd, torch.zeros_like(xd))
    n_m = _reduce_fast_n(xm)
    xr_m = xm - n_m.double() * _HPI
    xl, n_l = _reduce_large(torch.where(large, bits, torch.zeros_like(bits)))
    xl = torch.where(bits < 0, -xl, xl)
    xr = torch.where(medium, xr_m, xl)
    n = torch.where(medium, n_m, n_l)
    y0 = xr.float()
    y1 = (xr - y0.double()).float()
    reduced = medium | large
    iy = torch.where(reduced, 1 - ((n & 1) << 1), 1)
    out = _kernel_tanf(torch.where(reduced, y0, x),
                       torch.where(reduced, y1, torch.zeros_like(x)), iy)
    nan = torch.where(torch.isnan(x), _quiet(x),
                      _from_bits(torch.full_like(bits, _DEFAULT_NAN)))
    return torch.where(ix >= 0x7F800000, nan, out)


# ---------------------------------------------------------------------------
# atan2f (glibc 2.36 e_atan2f.c, s_atanf.c: fdlibm)
# ---------------------------------------------------------------------------

# the float32 values glibc's compiled tables hold (aT[0] is 0x3eaaaaab)
_ATANHI = _w32(0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATANLO = _w32(0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
_AT = _w32(0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E,
           0xBD9D8795, 0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221,
           0x3C8569D7)
_PI, _PI_LO, _PI_O_2, _PI_O_4 = _w32(0x40490FDB, 0xB3BBBD2E, 0x3FC90FDB,
                                     0x3F490FDB)
_ATAN_INF = float(np.float32(_ATANHI[3]) + np.float32(_ATANLO[3]))
_PI_O_2_LO = float(np.float32(_PI_O_2) + np.float32(0.5) * np.float32(_PI_LO))
_3PI_O_4 = float(np.float32(3.0) * np.float32(_PI_O_4))


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


def atan2f_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atan2f(y, x)`` (what XLA:CPU calls for ``jnp.arctan2``)
    of float32 tensors (broadcast): ``torch.atan2`` and CUDA's ``atan2f``
    round differently."""
    y, x = torch.broadcast_tensors(y, x)
    hx = x.view(torch.int32)
    hy = y.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    iy = hy & 0x7FFFFFFF
    k = (iy - ix) >> 23
    q = _flush(_flush(y) / torch.where(ix == 0, torch.ones_like(x),
                                       _flush(x)))
    z = _atanf_pos(torch.abs(q))
    # a quotient 0/0 of two subnormals: the invalid operation's NaN
    z = torch.where(torch.isnan(q), _from_bits(torch.full_like(
        hx, 0x7FC00000)), z)
    z = torch.where(k > 60, torch.full_like(z, _PI_O_2_LO), z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    pi = torch.full_like(z, _PI)
    neg_x = hx < 0
    neg_y = hy < 0
    out = torch.where(neg_x, torch.where(neg_y, (z - _PI_LO) - pi,
                                         pi - (z - _PI_LO)),
                      torch.where(neg_y, -z, z))
    # a NaN z keeps its bits but for case 1's sign flip (a bit operation:
    # negation is free to change a NaN's bits)
    flip = _from_bits(_bits(z) ^ -2147483648)
    out = torch.where(torch.isnan(z), torch.where(neg_y & ~neg_x, flip, z),
                      out)
    half_pi = torch.where(neg_y, -_PI_O_2, _PI_O_2).to(z.dtype)
    # glibc's order, last first: y infinite; x infinite; x = 0; y = 0;
    # x = 1; NaN
    inf_x, inf_y = ix == 0x7F800000, iy == 0x7F800000
    out = torch.where(inf_y, half_pi, out)
    quarter = torch.where(neg_x, _3PI_O_4, _PI_O_4).to(z.dtype)
    at_inf = torch.where(inf_y, quarter,
                         torch.where(neg_x, pi, torch.zeros_like(z)))
    out = torch.where(inf_x, torch.where(neg_y, -at_inf, at_inf), out)
    out = torch.where((ix == 0) & (iy != 0), half_pi, out)
    out = torch.where(iy == 0, torch.where(neg_x, torch.where(neg_y, -pi, pi),
                                           y), out)
    # x = 1: atanf(y), whose tiny arguments come back unflushed
    at1 = _atanf_pos(torch.abs(y))
    out = torch.where(hx == 0x3F800000, torch.where(neg_y, -at1, at1), out)
    nan_x, nan_y = torch.isnan(x), torch.isnan(y)
    out = torch.where(nan_x, _quiet(x), torch.where(nan_y, _quiet(y), out))
    return out


# ---------------------------------------------------------------------------
# expf, logf (XLA:CPU's own polynomials, LLVM's fused steps on Zen 5)
# ---------------------------------------------------------------------------

(_EXP_LO, _EXP_HI, _LOG2E, _LN2_HI, _LN2_LO, _EP0, _EP1, _EP2, _EP3,
 _EP4) = _w32(0xC2AF999A, 0x42B1999A, 0x3FB8AA3B, 0x3F318000, 0xB95E8083,
              0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA)


def expf_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's ``exp`` of float32 ``x``: clamp to [-87.8, 88.8], n =
    floor(fma(x, log2 e, 1/2)) clamped to [-127, 127], r = x - n ln2 in
    two fused steps, a degree-5 polynomial in fused steps, (1 + fma(p, r^2,
    r)) 2^n. NaN passes through every clamp."""
    from .fused import fma_f32_plain as fma_f32
    xc = torch.where(x < _EXP_LO, _EXP_LO, x)
    xc = torch.where(xc > _EXP_HI, _EXP_HI, xc).to(x.dtype)
    half = torch.full_like(x, 0.5)
    fx = torch.floor(fma_f32(xc, torch.full_like(x, _LOG2E), half))
    fx = torch.where(fx < -127.0, -127.0, fx)
    fx = torch.where(fx > 127.0, 127.0, fx).to(x.dtype)
    r = fma_f32(-fx, torch.full_like(x, _LN2_HI), xc)
    r = fma_f32(-fx, torch.full_like(x, _LN2_LO), r)
    p = fma_f32(r, torch.full_like(x, _EP0), torch.full_like(x, _EP1))
    for c in (_EP2, _EP3, _EP4, 0.5):
        p = fma_f32(p, r, torch.full_like(x, c))
    y = fma_f32(p, r * r, r) + 1.0
    n = torch.where(torch.isnan(fx), 0.0, fx).to(torch.int32)
    out = _flush(y * _from_bits((n << 23) + 0x3F800000))
    return torch.where(torch.isnan(x), _quiet(x), out)


(_MIN_NORM, _SQRTHF, _LP0, _LP1, _LP2, _LP3, _LP4, _LP5, _LP6, _LP7,
 _LP8) = _w32(0x00800000, 0x3F3504F3, 0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A,
              0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC,
              0x3EAAAAAA)


def logf_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's ``log`` of float32 ``x``: subnormals flushed to the
    smallest normal, the mantissa m in [sqrt(1/2), sqrt(2)) and the
    exponent e, three interleaved polynomials in fused steps, then
    ``fma(e, ln2_hi, (x - x^2/2 fused) + fma(y, x^3, e ln2_lo))``. x <= 0
    and NaN give the all-ones NaN, 0 gives -inf, +inf stays."""
    from .fused import fma_f32_plain as fma_f32
    x = _flush(x)
    bits = _bits(x)
    invalid = ~(x > 0)
    xc = torch.where(x > _MIN_NORM, x, torch.full_like(x, _MIN_NORM))
    cb = _bits(xc)
    e = ((cb >> 23) - 127).to(x.dtype) + 1.0
    m = _from_bits((cb & -2139095041) | 0x3F000000)   # & 0x807fffff
    lt = m < _SQRTHF
    e = e - torch.where(lt, 1.0, 0.0).to(x.dtype)
    v = (m - 1.0) + torch.where(lt, m, torch.zeros_like(m))
    z = v * v
    v3 = z * v
    y1 = fma_f32(v, torch.full_like(v, _LP0), torch.full_like(v, _LP1))
    y2 = fma_f32(v, torch.full_like(v, _LP3), torch.full_like(v, _LP4))
    y3 = fma_f32(v, torch.full_like(v, _LP6), torch.full_like(v, _LP7))
    y1 = fma_f32(y1, v, torch.full_like(v, _LP2))
    y2 = fma_f32(y2, v, torch.full_like(v, _LP5))
    y3 = fma_f32(y3, v, torch.full_like(v, _LP8))
    y = fma_f32(y1, v3, y2)
    y = fma_f32(y, v3, y3)
    y = fma_f32(y, v3, e * _LN2_LO)
    out = fma_f32(z, torch.full_like(v, -0.5), v) + y
    out = fma_f32(e, torch.full_like(v, _LN2_HI), out)
    ob = torch.where(invalid, torch.full_like(bits, -1), _bits(out))
    ob = torch.where(x == 0, torch.full_like(bits, -8388608), ob)
    ob = torch.where(x == math.inf, torch.full_like(bits, 0x7F800000), ob)
    return _from_bits(ob)


# ---------------------------------------------------------------------------
# 1.2 ** k (glibc's powf at the octave powers)
# ---------------------------------------------------------------------------

OCTAVE_BASE = 1.2             # the ORB pyramid's scale factor
OCTAVE_K = 16                 # octave_pow holds the exponents -16..16
# the reference's float32 1.2 ** k for k = -16..16 (XLA:CPU calls glibc's
# powf), bit patterns; float32 torch.pow on the card rounds k = 2 and 13
# otherwise
OCTAVE_POW_BITS = (
    0x3D5D8B3B, 0x3D84ED24, 0x3D9F82F8, 0x3DBF69F7, 0x3DE5B25C, 0x3E09D16B,
    0x3E2561B4, 0x3E46753F, 0x3E6E264C, 0x3E8EE3C8, 0x3EAB77BD, 0x3ECDC2E3,
    0x3EF6E9DE, 0x3F1425EC, 0x3F31C71C, 0x3F555555, 0x3F800000, 0x3F99999A,
    0x3FB851EC, 0x3FDD2F1C, 0x4004B5DE, 0x401F40A5, 0x403F1A60, 0x406552DA,
    0x4089981D, 0x40A51CF0, 0x40C622BA, 0x40EDC346, 0x410EA85D, 0x412B3071,
    0x414D6D54, 0x41768333, 0x4193E852)
_QNAN = 0x7FC00000


def octave_pow_plain(k: torch.Tensor) -> torch.Tensor:
    """float32 ``1.2 ** k`` of float32 ``k`` as the reference's ``powf``
    gives it, for the integers -16..16 the pyramid's octaves reach (a
    table); NaN for any other exponent."""
    table = torch.tensor(OCTAVE_POW_BITS, dtype=torch.int64,
                         device=k.device).to(torch.int32).view(torch.float32)
    ok = (k == torch.round(k)) & (k >= -OCTAVE_K) & (k <= OCTAVE_K)
    idx = torch.where(ok, k + OCTAVE_K, torch.zeros_like(k)).long()
    return torch.where(ok, table[idx], _from_bits(torch.full_like(
        _bits(k), _QNAN)))


def octave_pow(k: torch.Tensor, base: float = OCTAVE_BASE) -> torch.Tensor:
    """``base ** k`` (float32) at integer octave exponents, with the
    reference's bits: the twin on the CPU, one kernel launch on CUDA. Only
    the pyramid's base 1.2 is held."""
    if float(np.float32(base)) != float(np.float32(OCTAVE_BASE)):
        raise ValueError(f"octave_pow holds base {OCTAVE_BASE}, not {base}")
    k = k.to(torch.float32)
    if k.device.type == "cuda":
        return _launch_elementwise("octave_pow", k)
    return octave_pow_plain(k)


# ---------------------------------------------------------------------------
# the kernel (csrc/libm.cu)
# ---------------------------------------------------------------------------


def _count(name: str) -> None:
    global launches
    launches += 1
    launches_by_fn[name] = launches_by_fn.get(name, 0) + 1


def _meta(shape, operands, last_strides=(0, 0)) -> np.ndarray:
    """The kernel's index description: the number of dimensions, their
    sizes, each operand's strides in elements (0 where it broadcasts), and
    for ``contract`` the strides of x and y along the contracted axis.
    Dimensions of size one are dropped, and neighbours that every operand
    steps through as one are merged (contiguous operands index as one
    dimension)."""
    dims = [i for i, s in enumerate(shape) if s != 1]
    sizes = [int(shape[i]) for i in dims]
    strides = [[int(t.stride(i)) for i in dims] for t in operands]
    # merge a dimension into the next where every operand steps through
    # both as through one
    j = len(sizes) - 2
    while j >= 0:
        if all(st[j] == st[j + 1] * sizes[j + 1] for st in strides):
            sizes[j:j + 2] = [sizes[j] * sizes[j + 1]]
            for st in strides:
                st[j:j + 2] = [st[j + 1]]
        j -= 1
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"libm kernel indexes at most {MAX_DIMS} "
                         f"dimensions, got shape {tuple(shape)}")
    meta = np.zeros(1 + 4 * MAX_DIMS + 2, np.int64)
    meta[0] = len(sizes)
    meta[1:1 + len(sizes)] = sizes
    for o, st in enumerate(strides):
        meta[1 + MAX_DIMS * (o + 1):1 + MAX_DIMS * (o + 1) + len(st)] = st
    meta[-2:] = last_strides
    return meta


def _launch(name: str, out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, meta: np.ndarray, k: int = 0) -> torch.Tensor:
    from ..kernels.build import launcher

    dev = out.device
    for t in (a, b, c):
        if t.device != dev:
            raise ValueError(f"libm.{name}: operands on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"libm.{name} takes float32, got {t.dtype}")
    if out.numel() == 0:
        return out
    fn = launcher("libm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_FID[name], a.data_ptr(), b.data_ptr(), c.data_ptr(),
                out.data_ptr(), out.numel(), k,
                meta.ctypes.data_as(ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"libm kernel launch failed ({name}): CUDA error "
                           f"{rc}")
    _count(name)
    return out


def _launch_elementwise(name: str, *args: torch.Tensor) -> torch.Tensor:
    """One launch of function ``name`` over broadcast float32 CUDA
    operands (any strides); a missing operand repeats the first."""
    shape = torch.broadcast_shapes(*(t.shape for t in args))
    ops = [t.expand(shape) for t in args]
    ops += [ops[0]] * (3 - len(ops))
    out = torch.empty(shape, dtype=torch.float32, device=args[0].device)
    return _launch(name, out, *ops, _meta(shape, ops))


def fma_cuda(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor
             ) -> torch.Tensor:
    """``x * y + acc`` rounded once (``__fmaf_rn``), one launch."""
    return _launch_elementwise("fma", x, y, acc)


def contract_cuda(x: torch.Tensor, y: torch.Tensor,
                  zero: torch.Tensor | None = None) -> torch.Tensor:
    """``contract_f32`` in one launch: per output the product of element 0
    plus ``zero`` (+0 by default), then one fused step per further
    element."""
    k = int(max(x.shape[-1], y.shape[-1]))
    batch = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1],
                                   () if zero is None else zero.shape)
    xe = x.expand(batch + (k,))
    ye = y.expand(batch + (k,))
    z = (torch.zeros((), dtype=torch.float32, device=x.device)
         if zero is None else zero).expand(batch)
    out = torch.empty(batch, dtype=torch.float32, device=x.device)
    xb, yb = xe[..., 0], ye[..., 0]
    meta = _meta(batch, [xb, yb, z], (xe.stride(-1), ye.stride(-1)))
    return _launch("contract", out, xe, ye, z, meta, k)


# ---------------------------------------------------------------------------
# dispatch, derivatives, vmap
# ---------------------------------------------------------------------------

_PLAIN = {"tan": tanf_plain, "exp": expf_plain, "log": logf_plain,
          "sin": sinf_plain, "cos": cosf_plain, "atan2": atan2f_plain}
_LIBRARY = {"tan": torch.tan, "exp": torch.exp, "log": torch.log,
            "sin": torch.sin, "cos": torch.cos, "atan2": torch.atan2}


def _run(name: str, *args: torch.Tensor) -> torch.Tensor:
    """The function on plain tensors: the twin on the CPU, the kernel on
    CUDA."""
    if args[0].device.type == "cuda":
        return _launch_elementwise(name, *args)
    return _PLAIN[name](*args)


def _vmap_args(in_dims, args):
    """Batched arguments of an elementwise function with their batch
    dimension moved to the front and every argument aligned to the
    broadcast of the logical shapes."""
    size = next(a.shape[d] for a, d in zip(args, in_dims) if d is not None)
    logical = [a.shape if d is None else a.shape[:d] + a.shape[d + 1:]
               for a, d in zip(args, in_dims)]
    nd = len(torch.broadcast_shapes(*logical))
    out = []
    for a, d, shp in zip(args, in_dims, logical):
        a = a.unsqueeze(0) if d is None else a.movedim(d, 0)
        a = a.reshape((a.shape[0],) + (1,) * (nd - len(shp)) + tuple(shp))
        out.append(a.expand((size,) + a.shape[1:]) if d is None else a)
    return out


# JAX's forward-mode rules (jax/_src/lax/lax.py), with the functions here
_JVP = {
    "sin": lambda x, ans, t: t * cos(x),
    "cos": lambda x, ans, t: -(t * sin(x)),
    "tan": lambda x, ans, t: t * (1.0 + ans * ans),
    "exp": lambda x, ans, t: t * ans,
    "log": lambda x, ans, t: t / x,
}


def _function(name: str):
    """The ``torch.autograd.Function`` of unary ``name``: forward-mode
    derivative by JAX's rule, and under ``vmap`` one call on the physical
    tensor with the batch dimension first (a ctypes launch cannot read a
    batched tensor). No reverse mode: the port differentiates only with
    ``jacfwd``."""
    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return _run(name, x)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_forward(inputs[0], output)

        @staticmethod
        def jvp(ctx, t):
            x, ans = ctx.saved_tensors
            return _JVP[name](x, ans, t)

        @staticmethod
        def vmap(info, in_dims, x):
            return Fn.apply(x.movedim(in_dims[0], 0)), 0

    Fn.__name__ = Fn.__qualname__ = f"_{name.capitalize()}"
    return Fn


class _Atan2(torch.autograd.Function):
    @staticmethod
    def forward(y, x):
        return _run("atan2", y, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def vmap(info, in_dims, y, x):
        return _Atan2.apply(*_vmap_args(in_dims, (y, x))), 0

    @staticmethod
    def jvp(ctx, t_y, t_x):
        # JAX's rule for atan2(y, x): t_y (x / (y^2 + x^2)) plus
        # t_x (-y / (y^2 + x^2))
        y, x = ctx.saved_tensors
        den = y * y + x * x
        out = None
        if t_y is not None:
            out = t_y * (x / den)
        if t_x is not None:
            d = t_x * (-y / den)
            out = d if out is None else out + d
        return out


def _unary(name):
    fn = _function(name)

    def f(x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float64:
            return _LIBRARY[name](x)
        if plain_tensors(x):
            return _run(name, x)
        return fn.apply(x)
    f.__name__ = f.__qualname__ = name
    f.__doc__ = (f"float32 ``{name}`` with the reference's bits: the twin on "
                 f"the CPU, one kernel launch on CUDA (float64: the "
                 f"library's).")
    return f


sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
exp = _unary("exp")
log = _unary("log")


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 ``atan2(y, x)`` with the reference's bits (glibc's
    ``atan2f``): the twin on the CPU, one kernel launch on CUDA (float64:
    the library's)."""
    if torch.float64 in (y.dtype, x.dtype):
        return torch.atan2(y, x)
    if plain_tensors(y, x):
        return _run("atan2", y, x)
    return _Atan2.apply(y, x)


class _Fma(torch.autograd.Function):
    @staticmethod
    def forward(x, y, acc):
        return fma_cuda(x, y, acc)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0], inputs[1])

    @staticmethod
    def vmap(info, in_dims, x, y, acc):
        return _Fma.apply(*_vmap_args(in_dims, (x, y, acc))), 0

    @staticmethod
    def jvp(ctx, t_x, t_y, t_acc):
        x, y = ctx.saved_tensors
        parts = [t for t in (None if t_x is None else t_x * y,
                             None if t_y is None else x * t_y, t_acc)
                 if t is not None]
        out = parts[0]
        for t in parts[1:]:
            out = out + t
        return out


def fma(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``x * y + acc`` rounded once on CUDA tensors (broadcast):
    one launch, under ``jacfwd`` too."""
    if plain_tensors(x, y, acc):
        return fma_cuda(x, y, acc)
    return _Fma.apply(x, y, acc)


def plain_tensors(*ts: torch.Tensor) -> bool:
    """True when no argument is wrapped by a ``torch.func`` transform or
    needs autograd: the kernel (or the twin) may then run on it
    directly."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return not any(wrapped(t) or t.requires_grad for t in ts)
