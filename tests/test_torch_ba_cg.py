"""Parity: global BA over ``make_problem``'s layout against the JAX package.

The problem is ``test_ba_cg.py``'s consistent multi-view window (16
keyframes x 96 factors, 5 cm of pose and point noise,
0.4 px of pixel noise) in the window-contiguous layout that the
matrix-free PCG step needs, built with numpy and handed to both packages.
Held to 1e-4 (poses, and points within 1e-4 relative to their ~12 m
depth), with 256 landmarks where ``test_ba_cg.py`` has 1,024: there most
landmarks are seen once or not at all, and a landmark seen once has a
depth direction that only the damping bounds (ROADMAP C2), so which LM
steps the float32 solves accept is rounding in either package. One
``_lm_step`` candidate of the general layout, five ``lm_chunk``
iterations of the PCG and of the dense general-layout step (past them
the damping has fallen to 4e-7 and a landmark seen by few keyframes can
still send one package's candidate astray), ``bundle_adjustment(
window_layout=False)`` (3 + 2 iterations) and ``ChunkedLM(pose_stride > 0)`` chunk by chunk;
the costs 1e-4 relative, the inlier masks exactly. Two poses are held
fixed, not one as in ``test_ba_cg.py``: with one, the reduced system keeps
the monocular scale direction free, and whether its float32 Cholesky
fails at a near-converged step is rounding in either package (the
reference's own solve fails on iterations 4 and 6 of the dense run). One PCG candidate
step is held to 1e-3 instead: its 64 float32 CG iterations leave both
packages 6-7e-4 from the float64 solve of the same step (0.57 mm for the
reference, 0.74 mm for the port), so their float32 sums cannot agree
closer than that. The five-iteration ``lm_chunk`` runs are held to 5e-4:
each step's 1e-4-level float32 difference carries into the next
linearization (1.7e-4 and 1.9e-4 measured for the dense and PCG runs),
their points to 2e-4 relative: the port forms the PCG's block-Jacobi
preconditioner in float64 (ROADMAP C9), which moves the CG's iterates
by 1.3e-4 relative on the 16-20 m deep points after five iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.solver import ba as jba
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.solver import ba as tba

import torch_fixtures

NF = 96
# test_ba_cg.py's window at its small shapes, well posed (see above)
SHAPE = dict(K=16, nf=NF, M=256, spacing=0.1, n_fixed=2)
CAM = np.array([400.0, 400.0, 376.0, 240.0], np.float32)


def _arrays():
    return torch_fixtures.ba_problem_arrays(**SHAPE)


@pytest.fixture(scope="module")
def problems():
    a = _arrays()
    pj = jba.make_problem(
        jlie.SE3(jnp.asarray(a["R"]), jnp.asarray(a["t"])),
        jnp.asarray(a["pts"]), a["kf_idx"], a["mp_idx"], a["uv"],
        a["inv_s2"], a["valid"], jnp.asarray(a["fixed"]), jnp.asarray(CAM),
        max_obs=16)
    T = torch.from_numpy
    pt = tba.make_problem(
        tlie.SE3(T(a["R"]), T(a["t"])), T(a["pts"]), T(a["kf_idx"]),
        T(a["mp_idx"]), T(a["uv"]), T(a["inv_s2"]), T(a["valid"]),
        T(a["fixed"]), T(CAM), max_obs=16)
    np.testing.assert_array_equal(np.asarray(pj.lm_factor_idx),
                                  pt.lm_factor_idx.numpy())
    np.testing.assert_array_equal(np.asarray(pj.lm_factor_valid),
                                  pt.lm_factor_valid.numpy())
    return pj, pt


def _close(pj, pts_j, pt, pts_t, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=atol)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=atol)
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), atol=atol,
                               rtol=rtol)


def test_flat_inv3x3():
    rng = np.random.RandomState(3)
    A = rng.randn(64, 3, 3).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    H9 = A.reshape(64, 9)
    np.testing.assert_allclose(
        tba._flat_inv3x3(torch.from_numpy(H9)).numpy(),
        np.asarray(jba._flat_inv3x3(jnp.asarray(H9))), rtol=1e-5,
        atol=1e-6)


def test_lm_step_general_layout(problems):
    pj, pt = problems
    nj, xj, aj = jba._lm_step(pj.poses, pj.points, jnp.float32(1e-4),
                              jnp.ones_like(pj.valid), pj, "pinhole", 5.991,
                              True, window_layout=False)
    nt, xt, at = tba._lm_step(pt.poses, pt.points, torch.tensor(1e-4),
                              torch.ones_like(pt.valid), pt, "pinhole",
                              5.991, True, window_layout=False)
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())
    _close(nj, xj, nt, xt)


def test_lm_step_cg(problems):
    pj, pt = problems
    inl_j = jnp.ones_like(pj.valid)
    nj, xj, aj = jba._lm_step_cg(pj.poses, pj.points, jnp.float32(1e-4),
                                 inl_j, pj, "pinhole", 5.991, True, NF)
    nt, xt, at = tba._lm_step_cg(pt.poses, pt.points,
                                 torch.tensor(1e-4), torch.ones_like(
                                     pt.valid), pt, "pinhole", 5.991, True,
                                 NF)
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())
    _close(nj, xj, nt, xt, atol=1e-3)


@pytest.mark.parametrize("stride", [0, NF], ids=["dense", "pcg"])
def test_lm_chunk_general_layout(problems, stride):
    pj, pt = problems
    inl_j = jnp.ones_like(pj.valid)
    c0 = jba.lm_cost(pj.poses, pj.points, inl_j, pj, "pinhole")
    pj2, xj, _, cj, costs_j = jba.lm_chunk(
        pj.poses, pj.points, jnp.float32(1e-4), c0, inl_j, pj, "pinhole", 5,
        5.991, True, stride)
    inl_t = torch.ones_like(pt.valid)
    c0t = tba.lm_cost(pt.poses, pt.points, inl_t, pt, "pinhole")
    np.testing.assert_allclose(float(c0t), float(c0), rtol=1e-5)
    pt2, xt, _, ct, costs_t = tba.lm_chunk(
        pt.poses, pt.points, torch.tensor(1e-4), c0t, inl_t, pt, "pinhole",
        5, 5.991, True, stride)
    np.testing.assert_allclose(torch.stack(costs_t).numpy(),
                               np.asarray(costs_j), rtol=1e-4)
    _close(pj2, xj, pt2, xt, atol=5e-4, rtol=2e-4)
    assert float(ct) < 0.5 * float(c0t)


def test_bundle_adjustment_general_layout(problems):
    pj, pt = problems
    Pj, Xj, Ij, Cj = jba.bundle_adjustment(pj, "pinhole", 3, 2,
                                           window_layout=False)
    Pt, Xt, It, Ct = tba.bundle_adjustment(pt, "pinhole", 3, 2,
                                           window_layout=False)
    np.testing.assert_array_equal(np.asarray(Ij), It.numpy())
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=1e-4)
    _close(Pj, Xj, Pt, Xt)


def test_chunked_lm_pcg_chunk_by_chunk(problems):
    pj, pt = problems
    lj = jba.ChunkedLM(pj, "pinhole", 2, 3, chunk=2, pose_stride=NF)
    lt = tba.ChunkedLM(pt, "pinhole", 2, 3, chunk=2, pose_stride=NF)
    while not lj.done:
        assert lj.step() == lt.step()
        assert lj.phase == lt.phase and lj.left == lt.left
        np.testing.assert_allclose(float(lt.cost), float(lj.cost),
                                   rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(lj.inlier),
                                      lt.inlier.numpy())
        _close(lj.poses, lj.points, lt.poses, lt.points)
    assert lt.done
