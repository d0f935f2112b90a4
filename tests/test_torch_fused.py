"""``orb_slam_fusion_tpu_torch/utils/fused.py`` and the two-view polish
that uses it (ROADMAP C14a).

* ``fma_f32`` against the exact value ``x * y + acc`` (fractions), rounded
  once to float32, ties to even: random operands over a wide exponent
  range, constructed halfway ties, sums that float64 rounds onto a
  float32 midpoint (where only the TwoSum error decides), signed zeros.
* ``contract_f32`` against a chain of those exact fused steps, and
  against XLA:CPU's own compiled small dots (``J^T J`` and ``J^T r`` of
  the triangulation's shapes): every value bit-exact.
* ``sq_add_f32`` returns the bits of its earlier float64 form.
* ``solve3_f32`` against ``jnp.linalg.solve`` (LAPACK through scipy's
  OpenBLAS) bit for bit, on OpenBLAS's SkylakeX core, which scipy loads on
  an AVX-512 host; the test skips on another core, whose kernels round
  the solve in another order.
* ``cameras.triangulate_refine`` against the reference's, one to three
  Gauss-Newton steps from the same start: bit-exact (NaN rows where the
  reference's are NaN).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import cameras as jcam
from orb_slam_fusion_tpu_torch import cameras as tcam
from orb_slam_fusion_tpu_torch.utils.fused import (contract_f32, fma_f32,
                                                   solve3_f32, sq_add_f32)

F32 = np.float32


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest to the rational ``q``, ties to even."""
    r = F32(float(q))
    best = None
    for c in (np.nextafter(r, F32(-np.inf)), r, np.nextafter(r, F32(np.inf))):
        if not np.isfinite(c):
            continue
        d = abs(Fraction(float(c)) - q)
        even = int(np.array(c).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def _fma_exact(x, y, acc):
    """float32 fma by exact arithmetic, elementwise over numpy arrays."""
    out = np.empty(np.broadcast(x, y, acc).shape, F32)
    for i, (a, b, c) in enumerate(np.broadcast(x, y, acc)):
        q = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
        if q == 0:
            # an exact zero sum: -0 only when both addends are -0
            p = F32(a) * F32(b)
            out.flat[i] = F32(-0.0) if (np.signbit(p) and np.signbit(c)
                                        ) else F32(0.0)
        else:
            out.flat[i] = _round_f32(q)
    return out


def _ties(rng, n):
    """``acc + x * y`` on an exact midpoint, and within 2^-46 of one on
    either side, where float64 rounds the sum onto the midpoint."""
    r = (rng.uniform(1, 2, n) * 2.0 ** rng.randint(-20, 20, n)).astype(F32)
    e = np.frexp(r)[1].astype(np.int64) - 1            # r = m * 2^e, m in [1,2)
    half = np.ldexp(1.0, e - 24)                       # half an ulp of r
    k = rng.randint(-10, 10, n)
    x = np.ldexp(1.0, k).astype(F32)
    y = (half / np.ldexp(1.0, k)).astype(F32)
    up = np.nextafter(r, F32(np.inf))
    below = (F32(1 + 2.0 ** -23), F32(1 - 2.0 ** -23))  # product 1 - 2^-46
    xs = [x, x * below[0], x * below[0], -x, -x * below[0]]
    ys = [y, y * below[1], y * below[1], y, y * below[1]]
    accs = [r, r, np.nextafter(r, F32(-np.inf)), up, up]
    return (np.concatenate(xs).astype(F32), np.concatenate(ys).astype(F32),
            np.concatenate(accs).astype(F32))


def _cases(kind, rng):
    if kind == "random":
        n = 3000
        x = (rng.randn(n) * 2.0 ** rng.randint(-30, 30, n)).astype(F32)
        y = (rng.randn(n) * 2.0 ** rng.randint(-30, 30, n)).astype(F32)
        acc = (rng.randn(n) * 2.0 ** rng.randint(-60, 60, n)).astype(F32)
        # cancellation: acc near -x*y
        acc[::3] = (-(x[::3].astype(np.float64) * y[::3])
                    * (1 + rng.randn(1000) * 1e-6)).astype(F32)
        return x, y, acc
    if kind == "ties":
        return _ties(rng, 600)
    # signed zeros: zero products and zero accumulators of either sign
    z = np.array([0.0, -0.0], F32)
    v = np.array([0.0, -0.0, 1.5, -1.5, 3e-39, -3e-39], F32)
    x, y, acc = np.meshgrid(v, v, np.concatenate([z, v]), indexing="ij")
    return x.ravel(), y.ravel(), acc.ravel()


@pytest.mark.parametrize("kind", ["random", "ties", "signed_zeros"])
def test_fma_f32_rounds_once(kind):
    x, y, acc = _cases(kind, np.random.RandomState(7))
    want = _fma_exact(x, y, acc)
    got = fma_f32(torch.from_numpy(x), torch.from_numpy(y),
                  torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if kind == "ties":
        # the naive float64 sum rounded once more gets some of them wrong
        naive = (x.astype(np.float64) * y + acc).astype(F32)
        assert (naive != want).any()


def _sq_add_before(x, acc):
    """``sq_add_f32`` as the package had it before ``fma_f32``: the exact
    square plus ``acc`` in float64, the halfway cases decided by TwoSum
    against both neighbours."""
    a = x.double() * x.double()
    b = acc.double()
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r = torch.where(((r.double() + up.double()) * 0.5 == s) & (e > 0), up, r)
    return torch.where(((r.double() + dn.double()) * 0.5 == s) & (e < 0), dn,
                       r)


@pytest.mark.parametrize("kind", ["random", "ties", "signed_zeros"])
def test_sq_add_f32_keeps_its_bits(kind):
    x, _, acc = _cases(kind, np.random.RandomState(11))
    if kind == "ties":
        # squares on a midpoint: acc + x^2 with x a power of two
        r = acc
        e = np.frexp(r)[1].astype(np.int64) - 1
        ok = (e - 24) % 2 == 0
        x = np.ldexp(1.0, (e - 24) // 2).astype(F32)[ok]
        acc = r[ok]
    tx, tacc = torch.from_numpy(x), torch.from_numpy(acc)
    np.testing.assert_array_equal(
        sq_add_f32(tx, tacc).numpy().view(np.int32),
        _sq_add_before(tx, tacc).numpy().view(np.int32))
    np.testing.assert_array_equal(sq_add_f32(tx, tacc).numpy().view(np.int32),
                                  _fma_exact(x, x, acc).view(np.int32))


@pytest.mark.parametrize("terms,zero", [(3, 0.0), (4, 0.0), (4, -0.0)])
def test_contract_f32_is_a_fused_chain(terms, zero):
    """One fused chain from a signed zero, element 0 first."""
    rng = np.random.RandomState(terms)
    n = 400
    x = (rng.randn(n, terms) * 2.0 ** rng.randint(-8, 8, (n, terms))
         ).astype(F32)
    y = (rng.randn(n, terms) * 2.0 ** rng.randint(-8, 8, (n, terms))
         ).astype(F32)
    x[:40] = 0.0
    y[:20] = -y[:20]
    acc = np.full(n, zero, F32)
    for k in range(terms):
        acc = _fma_exact(x[:, k], y[:, k], acc)
    got = contract_f32(torch.from_numpy(x), torch.from_numpy(y),
                       torch.tensor(zero))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  acc.view(np.int32))


def test_contract_f32_is_xlas_small_dot():
    """``J^T J`` and ``J^T r`` of (N, 4, 3) Jacobians as XLA:CPU compiles
    them inside a loop (the triangulation's Gauss-Newton body)."""
    rng = np.random.RandomState(5)
    J = rng.randn(512, 4, 3).astype(F32) * F32(30)
    r = rng.randn(512, 4).astype(F32)

    def body(_, c):
        J, r, H, g = c
        return (J, r, jnp.einsum("...ki,...kj->...ij", J, J),
                jnp.einsum("...ki,...k->...i", J, r))

    _, _, H, g = jax.jit(lambda J, r: jax.lax.fori_loop(
        0, 1, body, (J, r, jnp.zeros((512, 3, 3), F32),
                     jnp.zeros((512, 3), F32))))(J, r)
    tJ, tr = torch.from_numpy(J), torch.from_numpy(r)
    Jt = tJ.transpose(-1, -2)
    got_H = contract_f32(Jt[..., :, None, :], Jt[..., None, :, :])
    got_g = contract_f32(Jt, tr[..., None, :], torch.tensor(-0.0))
    np.testing.assert_array_equal(got_H.numpy().view(np.int32),
                                  np.asarray(H).view(np.int32))
    np.testing.assert_array_equal(got_g.numpy().view(np.int32),
                                  np.asarray(g).view(np.int32))


def _scipy_openblas_core():
    import scipy.linalg
    import threadpoolctl
    scipy.linalg.cho_factor(np.eye(2))
    for d in threadpoolctl.threadpool_info():
        if (d.get("internal_api") == "openblas"
                and "scipy_openblas-" in d.get("filepath", "")):
            return d.get("architecture")
    return None


@pytest.mark.parametrize("kind", ["normal", "general", "tiny_pivots"])
def test_solve3_f32_is_lapacks_solve(kind):
    core = _scipy_openblas_core()
    if core not in ("SkylakeX", "Cooperlake"):
        pytest.skip(f"scipy's OpenBLAS runs its {core} core; solve3_f32 "
                    f"restates the SkylakeX one")
    rng = np.random.RandomState({"normal": 0, "general": 1,
                                 "tiny_pivots": 2}[kind])
    n = 4000
    if kind == "normal":
        J = rng.randn(n, 4, 3).astype(F32) * (
            F32(10) ** rng.uniform(-2, 2, (n, 1, 3)).astype(F32))
        A = (np.einsum("nki,nkj->nij", J, J)
             + F32(1e-9) * np.eye(3, dtype=F32)).astype(F32)
    else:
        A = rng.randn(n, 3, 3).astype(F32)
        if kind == "tiny_pivots":
            A[:, :, 0] *= F32(1e-20)
            A[::7, 1, 1] = A[::7, 0, 1] * A[::7, 1, 0] / A[::7, 0, 0]
            A[::11, :, 0] = 0.0                    # a zero first pivot
            A[5::13, :, 1] = 0.0                   # ... and a zero second one
    b = rng.randn(n, 3).astype(F32)
    want = np.asarray(jnp.linalg.solve(jnp.asarray(A),
                                       jnp.asarray(b)[..., None]))[..., 0]
    got = solve3_f32(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), np.nonzero(~same.all(-1))[0][:10]


def _rays(seed, n=2000):
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(seed)
    R = Rotation.from_rotvec(rng.randn(3) * 0.3).as_matrix().astype(F32)
    t = rng.randn(3).astype(F32)
    P = (rng.randn(n, 3) * [3, 3, 1] + [0, 0, 6]).astype(F32)
    r1 = (P / P[:, 2:]).astype(F32)
    P2 = P @ R.T + t
    r2 = (P2 / P2[:, 2:] + rng.randn(n, 3) * 1e-3 * [1, 1, 0]).astype(F32)
    return r1, r2, R, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_refine_bit_exact(seed):
    """From the reference's midpoint, each of one to three Gauss-Newton
    steps of the port equals the reference's compiled loop."""
    core = _scipy_openblas_core()
    if core not in ("SkylakeX", "Cooperlake"):
        pytest.skip(f"scipy's OpenBLAS runs its {core} core")
    r1, r2, R, t = _rays(seed)
    J = [jnp.asarray(a) for a in (r1, r2, R, t)]
    T = [torch.from_numpy(a) for a in (r1, r2, R, t)]
    X0 = jcam.triangulate_midpoint(*J)
    for iters in (1, 2, 3):
        want = np.asarray(jcam.triangulate_refine(X0, *J, iters=iters))
        got = tcam.triangulate_refine(torch.from_numpy(np.asarray(X0)), *T,
                                      iters=iters).numpy()
        same = (got.view(np.int32) == want.view(np.int32)) | (
            np.isnan(got) & np.isnan(want))
        assert same.all(), (iters, np.nonzero(~same.all(-1))[0][:10])


def test_fisheye_triangulation_golden():
    """``torch_goldens/fisheye_triangulation_frame0.npz`` (written by
    ``torch_triangulate_probe.py --write-golden``, held bit for bit on the
    card by ``chip_smoke.py``): the port's rays of the far-point case as
    the port makes them today, and its host triangulation of them, which
    equals the reference's on the same rays."""
    import os

    from torch_triangulate_probe import GOLDEN, case_rays
    g = np.load(os.path.join(os.path.dirname(__file__), "torch_goldens",
                             GOLDEN))
    c = case_rays()
    for i, k in enumerate(("ray1", "ray2", "R21", "t21")):
        np.testing.assert_array_equal(c["port"][i], g[k])
    T = [torch.from_numpy(g[k]) for k in ("ray1", "ray2", "R21", "t21")]
    got = tcam.triangulate(*T).numpy()
    want = np.asarray(jcam.triangulate(*[jnp.asarray(g[k]) for k in (
        "ray1", "ray2", "R21", "t21")]))
    for ref in (g["X"], want):
        same = (got.view(np.int32) == ref.view(np.int32)) | (
            np.isnan(got) & np.isnan(ref))
        assert same.all()
    far = int(g["far"])
    assert g["accepted"][far] and abs(got[far, 2] - 10.791099) < 1e-5
