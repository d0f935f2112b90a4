"""Parity: Sim(3) in ``lie.py`` and the Sim3 solvers against the JAX package.

Inputs are float32 arrays made with numpy from a seed and handed to both
packages. Tolerances: the group operations (exp, log, inverse, compose,
apply, the SE3 conversions) 1e-6 relative (1e-6 absolute near zero);
``horn_alignment`` 1e-5 (scale, rotation, translation, compared as
products, not as SVD factors, whose signs differ between libraries; the
fixed-scale mode and the reflection guard included); ``sim3_ransac``'s
minimal sets (the Gumbel top-k draws) and inlier masks exactly, its Sim3
1e-4; ``optimize_sim3`` 1e-4 with the inlier masks exact. The scenes are
``test_loop_components.py``'s: a Sim3 of scale 1.4 between two point sets
5 m in front of a 400 px camera, 30% of the pairs corrupted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.solver import sim3 as jsim3
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.solver import sim3 as tsim3
from orb_slam_fusion_tpu_torch.utils import prng

from test_torch_helpers import rot

CAM = np.array([400.0, 400.0, 320.0, 240.0], np.float32)


def _T(x):
    return torch.from_numpy(np.asarray(x))


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


def _xis(rng, n=64, scale=0.4):
    xi = (rng.randn(n, 7) * scale).astype(np.float32)
    xi[:8] *= 1e-4            # small angles and small log-scales
    xi[8:12, 6] = 0.0         # exactly unit scale
    xi[12:16, 3:6] = 0.0      # exactly zero rotation
    return xi


def test_sim3_group_ops():
    rng = np.random.RandomState(0)
    xa, xb = _xis(rng), _xis(rng)
    pts = rng.randn(64, 3).astype(np.float32)
    Ja, Jb = jlie.sim3_exp(jnp.asarray(xa)), jlie.sim3_exp(jnp.asarray(xb))
    Ta, Tb = tlie.sim3_exp(_T(xa)), tlie.sim3_exp(_T(xb))
    for f in range(3):
        _close(Ja[f], Ta[f])
    _close(jlie.sim3_log(Ja), tlie.sim3_log(Ta), rtol=1e-5, atol=1e-6)
    for jf, tf in ((jlie.sim3_inverse(Ja), tlie.sim3_inverse(Ta)),
                   (jlie.sim3_compose(Ja, Jb), tlie.sim3_compose(Ta, Tb))):
        for f in range(3):
            _close(jf[f], tf[f])
    _close(jlie.sim3_apply(Ja, jnp.asarray(pts)), tlie.sim3_apply(Ta,
                                                                  _T(pts)))
    R = np.stack([rot(v) for v in rng.randn(64, 3) * 0.5])
    t = rng.randn(64, 3).astype(np.float32)
    s = np.abs(rng.randn(64)).astype(np.float32) + 0.5
    Sj = jlie.sim3_from_se3(jlie.SE3(jnp.asarray(R), jnp.asarray(t)),
                            jnp.asarray(s))
    St = tlie.sim3_from_se3(tlie.SE3(_T(R), _T(t)), _T(s))
    for f in range(3):
        _close(Sj[f], St[f])
    _close(jlie.se3_from_sim3(Sj).t, tlie.se3_from_sim3(St).t)
    _close(jlie.sim3_from_se3(jlie.SE3(jnp.asarray(R), jnp.asarray(t))).s,
           tlie.sim3_from_se3(tlie.SE3(_T(R), _T(t))).s)
    Ij = jlie.sim3_identity((4,))
    It = tlie.sim3_identity((4,), device="cpu")
    for f in range(3):
        _close(Ij[f], It[f], rtol=0, atol=0)


def _scene(seed, n=120, n_out=36, scale=1.4):
    rng = np.random.RandomState(seed)
    x1 = (rng.uniform(-2, 2, (n, 3)) + [0, 0, 5]).astype(np.float32)
    R = rot([0.1, -0.2, 0.3])
    t = np.array([0.5, -0.3, 0.8], np.float32)
    x2_true = (scale * x1 @ R.T + t).astype(np.float32)
    x2 = x2_true.copy()
    x2[:n_out] += (rng.randn(n_out, 3) * 2.0).astype(np.float32)
    fx, fy, cx, cy = CAM

    def proj(p):
        return np.stack([fx * p[:, 0] / p[:, 2] + cx,
                         fy * p[:, 1] / p[:, 2] + cy], 1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-5:] = False
    return x1, x2, valid, proj(x1), proj(x2_true), (scale, R, t)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_alignment(fix_scale):
    rng = np.random.RandomState(2)
    x = rng.randn(32, 6, 3).astype(np.float32) + [0, 0, 5]
    R = np.stack([rot(v) for v in rng.randn(32, 3)])
    y = (1.3 * np.einsum("hij,hnj->hni", R, x)
         + rng.randn(32, 1, 3).astype(np.float32)
         + rng.randn(32, 6, 3).astype(np.float32) * 0.01)
    # a reflected set: the guard must still return a rotation
    y[0] = x[0] * np.array([1.0, 1.0, -1.0], np.float32)
    sj, Rj, tj = jsim3.horn_alignment(jnp.asarray(x), jnp.asarray(y),
                                      fix_scale=fix_scale)
    st, Rt, tt = tsim3.horn_alignment(_T(x), _T(y), fix_scale=fix_scale)
    for a, b in ((sj, st), (Rj, Rt), (tj, tt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-5)
    assert np.allclose(np.linalg.det(Rt.numpy()), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed,fix_scale", [(1, False), (5, True)])
def test_sim3_ransac(seed, fix_scale):
    x1, x2, valid, uv1, uv2, _ = _scene(seed)
    key = (jax.random.PRNGKey(seed * 7919 + 3))
    # the minimal sets: the reference's Gumbel top-k inside sim3_ransac
    g = jax.random.gumbel(key, (128, x1.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    idx_j = np.asarray(jax.lax.top_k(g, 3)[1])
    idx_t = prng.sample_minimal_sets(prng.PRNGKey(seed * 7919 + 3),
                                     _T(valid), 128, 3).numpy()
    np.testing.assert_array_equal(idx_t, idx_j)
    rj = jsim3.sim3_ransac(jnp.asarray(x1), jnp.asarray(x2),
                           jnp.asarray(valid), jnp.asarray(uv1),
                           jnp.asarray(uv2), jnp.asarray(CAM), key,
                           fix_scale=fix_scale)
    rt = tsim3.sim3_ransac(_T(x1), _T(x2), _T(valid), _T(uv1), _T(uv2),
                           _T(CAM), prng.PRNGKey(seed * 7919 + 3),
                           fix_scale=fix_scale)
    assert bool(rj.ok) == bool(rt.ok)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    for a, b in zip(rj.sim, rt.sim):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3(fix_scale):
    x1, x2, valid, uv1, uv2, (s, R, t) = _scene(4, n_out=10)
    xi0 = np.array([0.05, -0.03, 0.04, 0.02, -0.01, 0.03, 0.05], np.float32)
    S = jlie.Sim3(jnp.float32(s), jnp.asarray(R), jnp.asarray(t))
    S0 = jlie.sim3_compose(jlie.sim3_exp(jnp.asarray(xi0)), S)
    n = x1.shape[0]
    ones = np.ones(n, np.float32)
    Sj, inl_j, n_j = jsim3.optimize_sim3(
        S0, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(ones),
        jnp.asarray(ones), jnp.asarray(CAM), fix_scale=fix_scale)
    S0t = tlie.Sim3(*(_T(np.asarray(x)) for x in S0))
    St, inl_t, n_t = tsim3.optimize_sim3(
        S0t, _T(x1), _T(x2), _T(valid), _T(uv1), _T(uv2), _T(ones),
        _T(ones), _T(CAM), fix_scale=fix_scale)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)
    for a, b in zip(Sj, St):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
