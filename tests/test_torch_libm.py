"""PyTorch port parity: ``utils/libm.py``, the reference's float32 sin, cos,
tan, atan2, exp and log.

Tolerances:

* Each twin (``sinf_plain``, ``cosf_plain``, ``tanf_plain``, ``expf_plain``,
  ``logf_plain``, ``atan2f_plain``) equals the reference's function bit for
  bit, NaN bits included, jitted and eager: 2^20 float32 inputs over the
  ranges the port's call sites reach, a wide sample over the whole
  exponent range, and edge cases (+-0, subnormals, the neighbours of the
  range-reduction boundaries, infinities, NaNs).
* The forward-mode derivatives are JAX's rules evaluated with the twins,
  bit for bit; against ``jax.jvp`` within 1 ulp (rtol 2.4e-7), since the
  reference's eager and jitted tangents may round their products apart.
* ``jacfwd`` of ``lie.so3_exp``, ``sim3_exp`` and ``sim3_log`` through the
  Functions against ``jax.jacfwd`` of the reference: atol 1e-6 (the lie
  functions' products are not restated; the entries are O(1)).
* ``sim.so3_exp`` (the simulator's eager rotation) takes the twins and
  equals the reference's eager ``lie.so3_exp`` bit for bit.
* The octave powers ``1.2 ** k`` (``libm.octave_pow``: the reference's
  ``powf`` at the exponents the sites reach, -16..16) equal the
  reference's, jitted and eager.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jvp, vmap

from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.frontend.stereo import octave_scale
from orb_slam_fusion_tpu_torch.map import map_state as tms
from orb_slam_fusion_tpu_torch.utils import libm

N = 1 << 20

_JAX = {"sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan, "exp": jnp.exp,
        "log": jnp.log}
_PLAIN = {"sin": libm.sinf_plain, "cos": libm.cosf_plain,
          "tan": libm.tanf_plain, "exp": libm.expf_plain,
          "log": libm.logf_plain}
# the ranges the sites reach (lie's angles, KB8's theta, the Sim3 scale's
# log, idf ratios and distance ratios) and a wider one
_RANGES = {"sin": (-4.0, 4.0, 200.0), "cos": (-4.0, 4.0, 200.0),
           "tan": (0.0, 1.6, 200.0), "exp": (-10.0, 10.0, 100.0),
           "log": (0.0, 60.0, None)}


def _words(*w):
    return np.array(w, np.uint32).view(np.float32)


def _around(words, k=3):
    """The float32 values within k ulps of each bit pattern."""
    w = np.asarray(words, np.int64)
    return (w[:, None] + np.arange(-k, k + 1)[None, :]).reshape(-1).astype(
        np.uint32).view(np.float32)


def _edges(name):
    """+-0, subnormals, infinities, NaNs (quiet, negative, signalling
    payloads) and the neighbours of the function's branch boundaries."""
    common = [_words(0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0x807FFFFF,
                     0x00800000, 0x80800000, 0x7F800000, 0xFF800000,
                     0x7FC00000, 0xFFC00000, 0x7FC12345, 0x7F800001,
                     0x7F7FFFFF, 0xFF7FFFFF)]
    if name in ("sin", "cos"):
        half_pi = np.float32(np.pi / 2)
        mult = (np.arange(-80, 81) * np.float64(half_pi)).astype(np.float32)
        common += [_around([0x3F490FDB, 0x3F400000, 0x39800000, 0x42F00000,
                            0xC2F00000]), _around(mult.view(np.uint32), 2)]
    if name == "tan":
        mult = (np.arange(-80, 81) * np.pi / 2).astype(np.float32)
        common += [_around([0x3F490FDA, 0x3F2CA140, 0x39000000, 0x42F00000,
                            0xBF490FDA, 0xBF2CA140, 0x3FC90FDB]),
                   _around(mult.view(np.uint32), 2)]
    if name == "exp":
        common += [_around([0xC2AF999A, 0x42B1999A, 0xC2AEAC50, 0x42B17218,
                            0x3F800000, 0xBF800000])]
    if name == "log":
        common += [_around([0x3F800000, 0x3F3504F3, 0x00800000, 0x3F000000,
                            0x40000000]), _words(0xBF800000, 0x80000000)]
    return np.concatenate(common)


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi, wide = _RANGES[name]
    parts = [rng.uniform(lo, hi, N).astype(np.float32)]
    if wide is not None:
        parts.append(rng.uniform(-wide, wide, 1 << 16).astype(np.float32))
    mag = np.exp(rng.uniform(-85, 85, 1 << 16)).astype(np.float32)
    parts.append(mag * rng.choice([-1, 1], 1 << 16).astype(np.float32))
    parts.append(_edges(name))
    return np.concatenate(parts)


def _bits_differ(a, b):
    a = np.asarray(a, np.float32).view(np.uint32)
    b = np.asarray(b, np.float32).view(np.uint32)
    return np.flatnonzero(a != b)


@pytest.mark.parametrize("mode", ["jit", "eager"])
@pytest.mark.parametrize("name", ["sin", "cos", "tan", "exp", "log"])
def test_twin_is_the_references(name, mode):
    x = _inputs(name)
    f = _JAX[name]
    want = np.asarray(jax.jit(f)(x) if mode == "jit" else f(jnp.asarray(x)))
    got = _PLAIN[name](torch.from_numpy(x)).numpy()
    bad = _bits_differ(got, want)
    assert bad.size == 0, (name, bad.size, x[bad[:5]], want[bad[:5]],
                           got[bad[:5]])


@pytest.mark.parametrize("mode", ["jit", "eager"])
def test_atan2_twin_is_the_references(mode):
    rng = np.random.default_rng(1)
    y = np.concatenate([rng.uniform(-3, 3, N), rng.normal(size=1 << 16)
                        * np.exp(rng.uniform(-80, 80, 1 << 16))]
                       ).astype(np.float32)
    x = np.concatenate([rng.uniform(-3, 3, N), rng.normal(size=1 << 16)
                        * np.exp(rng.uniform(-80, 80, 1 << 16))]
                       ).astype(np.float32)
    e = np.concatenate([_edges("atan2"), np.float32([1.0, -1.0, 2.5, -0.3])])
    ey, ex = np.meshgrid(e, e)
    y = np.concatenate([y, ey.ravel()])
    x = np.concatenate([x, ex.ravel()])
    want = np.asarray(jax.jit(jnp.arctan2)(y, x) if mode == "jit"
                      else jnp.arctan2(jnp.asarray(y), jnp.asarray(x)))
    got = libm.atan2f_plain(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    bad = _bits_differ(got, want)
    assert bad.size == 0, (bad.size, y[bad[:5]], x[bad[:5]], want[bad[:5]],
                           got[bad[:5]])


@pytest.mark.parametrize("name", ["sin", "cos", "tan", "exp", "log"])
def test_public_function_on_cpu_is_the_twin(name):
    x = torch.from_numpy(_inputs(name, seed=3)[: 1 << 14])
    before = libm.launches
    got = getattr(libm, name)(x)
    assert libm.launches == before               # the CPU never launches
    assert torch.equal(got.view(torch.int32), _PLAIN[name](x).view(
        torch.int32))
    # float64 (comparison runs) takes the library's function
    x64 = x.double()[:64].abs() + 0.5
    assert torch.equal(getattr(libm, name)(x64), getattr(torch, name)(x64))


_RULES = {  # JAX's jvp rules (jax/_src/lax/lax.py) with the twins
    "sin": lambda x, ans, t: t * libm.cosf_plain(x),
    "cos": lambda x, ans, t: -(t * libm.sinf_plain(x)),
    "tan": lambda x, ans, t: t * (1.0 + ans * ans),
    "exp": lambda x, ans, t: t * ans,
    "log": lambda x, ans, t: t / x,
}


@pytest.mark.parametrize("name", ["sin", "cos", "tan", "exp", "log"])
def test_jvp_is_jaxs_rule(name):
    rng = np.random.default_rng(4)
    lo, hi, _ = _RANGES[name]
    x = rng.uniform(max(lo, 0.05) if name == "log" else lo, hi,
                    4096).astype(np.float32)
    t = rng.normal(size=4096).astype(np.float32)
    ans, tan_out = jvp(getattr(libm, name), (torch.from_numpy(x),),
                       (torch.from_numpy(t),))
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    assert torch.equal(ans, _PLAIN[name](xt))
    assert torch.equal(tan_out, _RULES[name](xt, ans, tt))
    j_ans, j_t = jax.jvp(_JAX[name], (jnp.asarray(x),), (jnp.asarray(t),))
    assert _bits_differ(ans.numpy(), np.asarray(j_ans)).size == 0
    np.testing.assert_allclose(tan_out.numpy(), np.asarray(j_t),
                               rtol=2.4e-7, atol=0)


def test_atan2_jvp_is_jaxs_rule():
    rng = np.random.default_rng(5)
    y, x, ty, tx = (rng.uniform(-2, 2, 4096).astype(np.float32)
                    for _ in range(4))
    args = tuple(torch.from_numpy(a) for a in (y, x))
    tans = tuple(torch.from_numpy(a) for a in (ty, tx))
    ans, t_out = jvp(libm.atan2, args, tans)
    den = args[0] * args[0] + args[1] * args[1]
    want = tans[0] * (args[1] / den) + tans[1] * (-args[0] / den)
    assert torch.equal(t_out, want)
    j_ans, j_t = jax.jvp(jnp.arctan2, (jnp.asarray(y), jnp.asarray(x)),
                         (jnp.asarray(ty), jnp.asarray(tx)))
    assert _bits_differ(ans.numpy(), np.asarray(j_ans)).size == 0
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_t), rtol=1e-6,
                               atol=1e-7)


def test_vmap_runs_the_functions_on_the_physical_tensor():
    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.uniform(-2, 2, (5, 3)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-2, 2, (3,)).astype(np.float32))
    got = vmap(libm.atan2, in_dims=(0, None))(y, x)
    assert torch.equal(got, libm.atan2f_plain(y, x))
    got = vmap(libm.atan2, in_dims=(1, 0))(y.T.contiguous(), y)
    assert torch.equal(got, libm.atan2f_plain(y, y))
    for name in ("sin", "cos", "tan", "exp", "log"):
        a = y.abs() + 0.1
        assert torch.equal(vmap(getattr(libm, name), in_dims=1)(a),
                           _PLAIN[name](a.T))
    # jacfwd is vmap over jvp: the diagonal is the rule, bit for bit
    xs = torch.from_numpy(rng.uniform(0.1, 1.5, 7).astype(np.float32))
    for name in ("sin", "cos", "tan", "exp", "log"):
        J = jacfwd(getattr(libm, name))(xs)
        rule = _RULES[name](xs, _PLAIN[name](xs), torch.ones_like(xs))
        assert torch.equal(J.diagonal(), rule), name
        assert torch.count_nonzero(J - torch.diag(J.diagonal())) == 0


def _jac_case(seed=7):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    xi = (rng.normal(size=(6, 7)) * 0.6).astype(np.float32)
    return w, xi


def test_so3_exp_jacfwd_matches_jax():
    w, _ = _jac_case()
    got = jacfwd(tlie.so3_exp)(torch.from_numpy(w)).numpy()
    want = np.asarray(jax.jacfwd(jlie.so3_exp)(jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _sim3_flat(mod, xp):
    def f(xi):
        S = mod.sim3_exp(xi)
        return xp.concatenate([S.s[..., None], S.R.reshape(
            S.R.shape[:-2] + (9,)), S.t], -1)
    return f


def test_sim3_exp_jacfwd_matches_jax():
    _, xi = _jac_case()
    got = jacfwd(_sim3_flat(tlie, torch))(torch.from_numpy(xi)).numpy()
    want = np.asarray(jax.jacfwd(_sim3_flat(jlie, jnp))(jnp.asarray(xi)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sim3_log_jacfwd_matches_jax():
    _, xi = _jac_case()
    S = jlie.sim3_exp(jnp.asarray(xi))
    s, R, t = (np.array(a) for a in S)
    ts, tR, tt = (torch.from_numpy(a) for a in (s, R, t))
    for k, (jarg, targ) in enumerate(((s, ts), (t, tt))):
        def tf(a, k=k):
            return tlie.sim3_log(tlie.Sim3(a, tR, tt) if k == 0
                                 else tlie.Sim3(ts, tR, a))

        def jf(a, k=k):
            return jlie.sim3_log(jlie.Sim3(a, R, t) if k == 0
                                 else jlie.Sim3(s, R, a))
        got = jacfwd(tf)(targ).numpy()
        want = np.asarray(jax.jacfwd(jf)(jnp.asarray(jarg)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("where", ["quadrant_edges", "random"])
def test_sim_so3_exp_is_the_references_eager(where):
    """The simulator's float32 Rodrigues exponential takes the twins: equal
    to the reference's eager ``lie.so3_exp`` bit for bit, at angles next to
    multiples of pi/2 too (there glibc's fused reduction decides the last
    bit; sim.py's earlier scalar sinf/cosf missed it at 74 pi/2)."""
    rng = np.random.default_rng(10)
    if where == "random":
        w = rng.normal(size=(4096, 3)).astype(np.float32)
    else:
        th = (np.arange(1, 77) * np.pi / 2).astype(np.float32)
        th = _around(th.view(np.uint32), 2)
        axis = rng.normal(size=(th.shape[0], 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        w = (axis * th[:, None]).astype(np.float32)
    want = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    got = tsim.so3_exp(w)
    assert _bits_differ(got, want).size == 0


def test_octave_powers_are_the_references():
    """Every ``1.2 ** k`` the port takes (tracking, mapping, loop closing,
    the scale band and the stereo tolerances, all through
    ``libm.octave_pow``) against the reference's, eager and jitted; the
    table is the reference's ``powf``, and other exponents give NaN."""
    k = np.arange(-16, 17, dtype=np.float32)
    want_eager = np.asarray(tms.SCALE_FACTOR ** jnp.asarray(k))
    want_jit = np.asarray(jax.jit(lambda o: tms.SCALE_FACTOR ** o)(k))
    assert _bits_differ(want_eager, want_jit).size == 0
    assert _bits_differ(np.array(libm.OCTAVE_POW_BITS, np.uint32).view(
        np.float32), want_jit).size == 0
    kt = torch.from_numpy(k)
    assert _bits_differ(libm.octave_pow(kt).numpy(), want_jit).size == 0
    assert _bits_differ(octave_scale(kt).numpy(), want_jit).size == 0
    octaves = torch.arange(0, 9, dtype=torch.int32)
    assert _bits_differ(octave_scale(octaves, 2).numpy(),
                        want_jit[16::2]).size == 0
    dist = torch.ones(k.shape[0])
    _, max_d = tms.scale_invariance_band(dist, kt, 8)
    assert _bits_differ(max_d.numpy(), want_jit).size == 0
    odd = libm.octave_pow(torch.tensor([0.5, -17.0, 17.0, math.nan]))
    assert torch.isnan(odd).all()
    with pytest.raises(ValueError):
        libm.octave_pow(kt, base=1.25)


def test_predict_scale_and_idf_take_the_references_log():
    rng = np.random.default_rng(9)
    ratio = np.exp(rng.uniform(-3, 3, 1 << 16)).astype(np.float32)
    want = np.asarray(jnp.log(jnp.asarray(ratio)))
    assert _bits_differ(libm.log(torch.from_numpy(ratio)).numpy(),
                        want).size == 0
    assert not math.isnan(float(libm.log(torch.tensor([1.0]))[0]))


def _kernel_offsets(meta, n):
    """The element offsets of the three operands that csrc/libm.cu computes
    from ``_meta``'s description, for outputs 0..n-1."""
    d, M = int(meta[0]), libm.MAX_DIMS
    size = meta[1:1 + d]
    offs = np.zeros((3, n), np.int64)
    rest = np.arange(n, dtype=np.int64)
    for k in range(d - 1, -1, -1):
        coord = rest % size[k]
        rest //= size[k]
        for o in range(3):
            offs[o] += coord * meta[1 + M * (o + 1) + k]
    return offs


@pytest.mark.parametrize("case", ["contiguous", "broadcast", "transposed",
                                  "sliced"])
def test_kernel_index_description_addresses_every_operand(case):
    """``_meta`` (the launch's description of shapes and strides) read as
    the kernel reads it gives every operand's element of each output."""
    g = torch.Generator().manual_seed(11)
    base = torch.randn(6, 8, 5, generator=g)
    if case == "contiguous":
        ops = [base, base + 1, base * 2]
    elif case == "broadcast":
        ops = [base, torch.randn(8, 1, generator=g), torch.randn(5,
                                                                 generator=g)]
    elif case == "transposed":
        ops = [base.transpose(0, 2), torch.randn(5, 8, 6, generator=g),
               base.permute(2, 1, 0)]
    else:
        ops = [base[:, ::2, 1:4], base[1:, 1::2, :3][:1],
               torch.randn(6, 4, 3, generator=g)]
    shape = torch.broadcast_shapes(*(t.shape for t in ops))
    ex = [t.expand(shape) for t in ops]
    meta = libm._meta(shape, ex)
    n = int(np.prod(shape))
    offs = _kernel_offsets(meta, n)
    for o, t in enumerate(ex):
        flat = t.as_strided((t.untyped_storage().nbytes() // 4,), (1,), 0)
        got = flat[torch.from_numpy(offs[o] + t.storage_offset())]
        assert torch.equal(got, t.reshape(-1)), (case, o)
    if case == "contiguous":
        assert meta[0] == 1            # one dimension: no division
