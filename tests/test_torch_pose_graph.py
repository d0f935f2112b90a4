"""Parity: the port's Sim3 pose graph (both modes) against the JAX package.

The problems are ``test_loop_components.py``'s: a 24-keyframe circle with
growing Sim3 drift and a loop edge (Sim3 mode), and a 10-keyframe yawing
circle with world-side yaw and translation drift (4-DoF mode). Both
packages get the same float32 inputs, built with numpy. Tolerance: poses
(s, R, t) 1e-4 absolute, the per-iteration costs 1e-4 relative (1e-8 absolute once converged
to float32 noise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.solver import pose_graph as jpg
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.solver import pose_graph as tpg

from test_torch_helpers import rot


def _sim(s, R, t):
    return (np.float32(s), np.asarray(R, np.float32),
            np.asarray(t, np.float32))


def _np_compose(A, B):
    return (A[0] * B[0], A[1] @ B[1], A[0] * (A[1] @ B[2]) + A[2])


def _np_inverse(S):
    Rt = S[1].T
    return (1.0 / S[0], Rt, -(1.0 / S[0]) * (Rt @ S[2]))


def _np_exp(xi):
    """Sim3 exp through the reference (host values only)."""
    S = jlie.sim3_exp(jnp.asarray(xi, jnp.float32))
    return _sim(S.s, S.R, S.t)


def _problem(four_dof):
    K = 10 if four_dof else 24
    rng = np.random.RandomState(1 if four_dof else 0)
    gt = []
    for k in range(K):
        ang = 2 * np.pi * k / K
        if four_dof:
            R = rot([0.0, 0.0, ang])
            t = [np.sin(ang) * 2, 1 - np.cos(ang) * 2, 0.0]
        else:
            R = rot([0.0, ang, 0.0])
            t = [np.sin(ang) * 3, 0.0, 3 - np.cos(ang) * 3]
        gt.append(_sim(1.0, R, t))
    ei = list(range(K - 1)) + [K - 1]
    ej = list(range(1, K)) + [0]
    rels = [_np_compose(gt[j], _np_inverse(gt[i])) for i, j in zip(ei, ej)]
    init = []
    for k in range(K):
        xi = np.zeros(7, np.float32)
        xi[:3] = rng.randn(3) * 0.05 * (k / K)
        if four_dof:
            xi[5] = 0.1 * (k / K)
            init.append(_np_compose(gt[k], _np_exp(xi)))
        else:
            xi[3:6] = rng.randn(3) * 0.02 * (k / K)
            xi[6] = 0.15 * (k / K)
            init.append(_np_compose(_np_exp(xi), gt[k]))

    def stack(lst):
        return tuple(np.stack([np.asarray(x[i], np.float32) for x in lst])
                     for i in range(3))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(poses=stack(init), rel=stack(rels),
                ei=np.asarray(ei, np.int32), ej=np.asarray(ej, np.int32),
                w=np.ones(K, np.float32), valid=np.ones(K, bool),
                fixed=fixed)


def _jax(p, four_dof):
    S = lambda a: jlie.Sim3(*(jnp.asarray(x) for x in a))  # noqa: E731
    prob = jpg.PoseGraphProblem(
        S(p["poses"]), jnp.asarray(p["ei"]), jnp.asarray(p["ej"]),
        S(p["rel"]), jnp.asarray(p["w"]), jnp.asarray(p["valid"]),
        jnp.asarray(p["fixed"]))
    poses, costs = jpg.optimize_pose_graph(prob, iters=30,
                                           four_dof=four_dof)
    return [np.asarray(x) for x in poses], np.asarray(costs)


def _port(p, four_dof):
    S = lambda a: tlie.Sim3(*(torch.from_numpy(x) for x in a))  # noqa
    prob = tpg.PoseGraphProblem(
        S(p["poses"]), torch.from_numpy(p["ei"]), torch.from_numpy(p["ej"]),
        S(p["rel"]), torch.from_numpy(p["w"]), torch.from_numpy(p["valid"]),
        torch.from_numpy(p["fixed"]))
    poses, costs = tpg.optimize_pose_graph(prob, iters=30,
                                           four_dof=four_dof)
    return [x.numpy() for x in poses], costs.numpy()


@pytest.mark.parametrize("four_dof", [False, True], ids=["sim3", "4dof"])
def test_pose_graph_matches_reference(four_dof):
    p = _problem(four_dof)
    (sj, Rj, tj), cj = _jax(p, four_dof)
    (st, Rt, tt), ct = _port(p, four_dof)
    np.testing.assert_allclose(st, sj, atol=1e-4)
    np.testing.assert_allclose(Rt, Rj, atol=1e-4)
    np.testing.assert_allclose(tt, tj, atol=1e-4)
    np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=1e-8)
    assert ct[-1] < 1e-6
    if four_dof:
        assert np.abs(st - 1.0).max() < 1e-6


def test_edge_residual_and_log_match_reference():
    """The residual of one edge under a perturbation, and Sim3 log/exp."""
    rng = np.random.RandomState(5)
    S = [_np_exp(rng.randn(7).astype(np.float32) * 0.3) for _ in range(3)]
    xi_i = (rng.randn(7) * 0.05).astype(np.float32)
    xi_j = (rng.randn(7) * 0.05).astype(np.float32)
    J = lambda a: jlie.Sim3(*(jnp.asarray(x) for x in a))  # noqa: E731
    T = lambda a: tlie.Sim3(*(torch.from_numpy(np.asarray(x))  # noqa
                              for x in a))
    for right in (False, True):
        rj = np.asarray(jpg._edge_residual(J(S[0]), J(S[1]), J(S[2]),
                                           jnp.asarray(xi_i),
                                           jnp.asarray(xi_j), right=right))
        rt = tpg._edge_residual(T(S[0]), T(S[1]), T(S[2]),
                                torch.from_numpy(xi_i),
                                torch.from_numpy(xi_j), right=right).numpy()
        np.testing.assert_allclose(rt, rj, atol=1e-5)
