"""The reference's inertial solvers, opened up (JAX; tests only).

``orb_slam_fusion_tpu/solver/vi_ba.py`` keeps its intermediate sums inside
its jitted programs. The parity tests of their order
(``test_torch_vi_ba_order.py``) and ``torch_viba1_replay.py`` need them, so
this module copies the reference's code line for line and returns what the
reference computes but does not return:

* ``inertial_blocks``: each preintegration factor's residual and its
  ``jax.jacfwd`` Jacobians, as ``inertial_system`` builds them (the body of
  its ``edge_blocks``, under ``vmap``, jitted);
* ``init_iterations``: ``inertial_init``'s loop, each iteration's residual,
  Jacobian, damped normal equations, step and candidate cost.

XLA:CPU compiles these copies as it compiles the reference (the tests hold
each copy's results to the reference's own: ``inertial_system``'s diagonal
blocks, ``inertial_init``'s candidate costs). The reference is not edited.
"""

import functools

import jax
import jax.numpy as jnp

from orb_slam_fusion_tpu import lie
from orb_slam_fusion_tpu.imu.factors import inertial_residual
from orb_slam_fusion_tpu.imu.preintegration import GRAVITY, ImuBias
from orb_slam_fusion_tpu.solver import vi_ba as jvi


@jax.jit
def inertial_blocks(state, ifac, calib, g_w):
    """(r (P,9), Ji, Jj (P,9,15)) of ``jvi.inertial_system``."""
    P = ifac.i.shape[0]
    D = 15

    def edge_res(k, dx_i, dx_j):
        pre_k = jax.tree_util.tree_map(lambda a: a[k], ifac.pre)
        pi = lie.se3_boxplus(
            lie.SE3(state.poses.R[ifac.i[k]], state.poses.t[ifac.i[k]]),
            dx_i[:6])
        pj = lie.se3_boxplus(
            lie.SE3(state.poses.R[ifac.j[k]], state.poses.t[ifac.j[k]]),
            dx_j[:6])
        return jvi._inertial_res_one(
            pre_k, None, pi, state.vel[ifac.i[k]] + dx_i[6:9],
            pj, state.vel[ifac.j[k]] + dx_j[6:9],
            state.bg[ifac.i[k]] + dx_i[9:12],
            state.ba[ifac.i[k]] + dx_i[12:15], calib, g_w)

    zero_dx = jnp.zeros(D, state.poses.t.dtype)

    def edge_blocks(k):
        r0 = edge_res(k, zero_dx, zero_dx)
        Ji = jax.jacfwd(lambda d: edge_res(k, d, zero_dx))(zero_dx)
        Jj = jax.jacfwd(lambda d: edge_res(k, zero_dx, d))(zero_dx)
        return r0, Ji, Jj

    return jax.vmap(edge_blocks)(jnp.arange(P))


@functools.partial(jax.jit, static_argnames=("iters", "optimize_scale"))
def init_iterations(poses, ifac, calib, iters=30, optimize_scale=True,
                    prior_g=1e2, prior_a=1e5):
    """``jvi.inertial_init``'s loop; per iteration (stacked): candidate
    cost c1, damped H, gvec with its prior, Jacobian (P,9,n), residual,
    theta, lam, step dx, cost c0."""
    K = poses.t.shape[0]
    P = ifac.i.shape[0]
    dtype = poses.t.dtype
    g0 = jnp.array([0.0, 0.0, -GRAVITY], dtype)
    R_wb, p_wb = jvi.body_state(poses, calib)
    n_par = 9 + 3 * K

    def unpack(theta):
        R_wg = lie.so3_exp(jnp.concatenate(
            [theta[:2], jnp.zeros(1, dtype)]))
        s = jnp.exp(theta[2]) if optimize_scale else jnp.asarray(1.0, dtype)
        bias = ImuBias(theta[3:6], theta[6:9])
        vel = theta[9:].reshape(K, 3)
        return R_wg, s, bias, vel

    def residuals(theta):
        R_wg, s, bias, vel = unpack(theta)
        g_w = R_wg @ g0

        def one(k):
            pre_k = jax.tree_util.tree_map(lambda a: a[k], ifac.pre)
            i, j = ifac.i[k], ifac.j[k]
            return inertial_residual(
                pre_k, R_wb[i], s * p_wb[i], vel[i],
                R_wb[j], s * p_wb[j], vel[j], bias, g_w)

        r = jax.vmap(one)(jnp.arange(P))
        return jnp.where(ifac.valid[:, None], r, 0.0)

    prior_vec = jnp.concatenate([jnp.full(3, prior_g, dtype),
                                 jnp.full(3, prior_a, dtype)])

    def cost(theta):
        r = residuals(theta)
        c = jnp.sum(jnp.einsum("pi,pij,pj->p", r, ifac.info, r))
        return c + jnp.sum(prior_vec * theta[3:9] ** 2)

    def body(carry, _):
        theta, lam = carry
        r = residuals(theta)
        J = jax.jacfwd(residuals)(theta).reshape(P * 9, n_par)
        Jb = J.reshape(P, 9, n_par)
        H = jnp.einsum("pri,prs,psj->ij", Jb, ifac.info, Jb)
        gvec = jnp.einsum("pri,prs,ps->i", Jb, ifac.info, r)
        H = H.at[jnp.arange(3, 9), jnp.arange(3, 9)].add(prior_vec)
        gvec = gvec.at[3:9].add(prior_vec * theta[3:9])
        H = H + jnp.diag(lam * jnp.diag(H) + 1e-7)
        dx = -jax.scipy.linalg.solve(H, gvec, assume_a="pos")
        c0 = cost(theta)
        c1 = cost(theta + dx)
        ok = (c1 < c0) & jnp.all(jnp.isfinite(dx))
        new_theta = jnp.where(ok, theta + dx, theta)
        new_lam = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9),
                            jnp.minimum(lam * 5.0, 1e6))
        return (new_theta, new_lam), dict(c1=c1, H=H, gvec=gvec, J=Jb, r=r,
                                          theta=theta, lam=lam, dx=dx,
                                          c0=c0)

    theta0 = jnp.zeros(n_par, dtype)
    _, out = jax.lax.scan(body, (theta0, jnp.asarray(1e-3, dtype)), None,
                          length=iters)
    return out
