"""The reference's PCG global-BA program, opened up (JAX; tests only).

``orb_slam_fusion_tpu/solver/ba.py::lm_chunk`` keeps the PCG step's
intermediate sums inside its jitted scan. The parity tests of their order
(``test_torch_pcg_order.py``) and ``torch_pcg_replay.py`` need them, so
``lm_chunk_opened`` copies ``lm_chunk`` -> ``_lm_scan`` -> ``_lm_step_cg``
line for line and returns, per LM iteration, what the reference computes
but does not return: the factors (``r``, ``Jp``, ``Jl`` after the finite
mask), the landmark system (``Hll``, ``gl`` after the fixed-point mask,
``Hll_inv``), the pose system (``Hpp``, ``g_r``), the steps ``dx_p`` and
``dx_l``, the candidate and its cost, and the state, damping and cost
the step started from.

XLA:CPU compiles the copy as it compiles the reference: the tests hold the
copy's carry and candidate costs to ``jba.lm_chunk``'s own, bit for bit,
at the test's static arguments. The reference is not edited.
"""

import functools

import jax
import jax.numpy as jnp

from orb_slam_fusion_tpu import lie
from orb_slam_fusion_tpu.solver import ba as jba
from orb_slam_fusion_tpu.solver.robust import huber_weight


def _lm_step_cg_opened(poses, points, lam, inlier, prob, cam_model, chi2_th,
                       use_robust, pose_stride, cg_iters):
    """``jba._lm_step_cg``, returning its intermediates as well."""
    dtype = points.dtype
    K = poses.t.shape[0]
    F = prob.kf_idx.shape[0]

    r, Jp, Jl, depth_ok = jba._eval_factors(poses, points, prob, cam_model)
    active = prob.valid & inlier & depth_ok
    chi2 = jnp.sum(r * r, axis=-1) * prob.inv_sigma2
    th_f = jba._factor_chi2_th(prob, chi2_th)
    w_rob = huber_weight(chi2, th_f) if use_robust else jnp.ones_like(chi2)
    w = jnp.where(active, w_rob * prob.inv_sigma2, 0.0).astype(dtype)

    Hll_f = jnp.einsum("fik,f,fil->fkl", Jl, w, Jl)
    Hpl_f = jnp.einsum("fik,f,fil->fkl", Jp, w, Jl)
    gp_f = jnp.einsum("fik,f,fi->fk", Jp, w, r)
    gl_f = jnp.einsum("fik,f,fi->fk", Jl, w, r)

    def pose_sum(x):
        return x.reshape((K, pose_stride) + x.shape[1:]).sum(axis=1)

    Hpp = pose_sum(jnp.einsum("fik,f,fil->fkl", Jp, w, Jp))
    gp = pose_sum(gp_f)

    fidx = jnp.clip(prob.lm_factor_idx, 0, F - 1)
    vmf = prob.lm_factor_valid.astype(dtype)
    Hll = jnp.einsum("mo,moij->mij", vmf, Hll_f[fidx])
    gl = jnp.einsum("mo,moi->mi", vmf, gl_f[fidx])

    eye3 = jnp.eye(3, dtype=dtype)
    Hll_d = Hll + lam * Hll * jnp.broadcast_to(eye3, Hll.shape) + 1e-8 * eye3
    fixl = prob.fixed_point[:, None, None]
    Hll_d = jnp.where(fixl, jnp.broadcast_to(eye3, Hll_d.shape), Hll_d)
    gl = jnp.where(prob.fixed_point[:, None], 0.0, gl)
    Hll_inv = jba.inv3x3(Hll_d)
    Hll_inv = jnp.where(fixl, 0.0, Hll_inv)

    fp = prob.fixed_pose
    Hinv_of_f = Hll_inv[prob.mp_idx]
    corr = jnp.einsum("fik,fkl,fl->fi", Hpl_f, Hinv_of_f, gl[prob.mp_idx])
    g_r = jnp.where(fp[:, None], 0.0, gp - pose_sum(corr))

    D_f = jnp.einsum("fik,fkl,fjl->fij", Hpl_f, Hinv_of_f, Hpl_f)
    S_diag = Hpp - pose_sum(D_f)
    dvec = jnp.einsum("kii->ki", S_diag)
    S_diag = S_diag + (lam * dvec + 1e-8)[:, :, None] * \
        jnp.broadcast_to(jnp.eye(6, dtype=dtype), S_diag.shape)
    S_diag = jnp.where(fp[:, None, None],
                       jnp.broadcast_to(jnp.eye(6, dtype=dtype),
                                        S_diag.shape), S_diag)
    Minv = jax.vmap(lambda A: jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(A, lower=True),
        jnp.eye(6, dtype=dtype)))(S_diag)

    damp = lam * dvec + 1e-8

    def matvec(v):
        v = jnp.where(fp[:, None], 0.0, v)
        t1 = jnp.einsum("fki,fk->fi", Hpl_f, v[prob.kf_idx])
        s_m = jnp.einsum("mo,moi->mi", vmf, t1[fidx])
        y = jnp.einsum("mij,mj->mi", Hll_inv, s_m)
        z = jnp.einsum("fik,fk->fi", Hpl_f, y[prob.mp_idx])
        Sv = jnp.einsum("kij,kj->ki", Hpp, v) - pose_sum(z) + damp * v
        return jnp.where(fp[:, None], v, Sv)

    def precon(x):
        return jnp.einsum("kij,kj->ki", Minv, x)

    b = -g_r
    x = jnp.zeros_like(b)
    res = b
    z = precon(res)
    p = z
    rz = jnp.sum(res * z)

    def cg_body(carry, _):
        x, res, p, rz = carry
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = jnp.where(jnp.abs(denom) > 1e-20, rz / denom, 0.0)
        x2 = x + alpha * p
        r2 = res - alpha * Ap
        z2 = precon(r2)
        rz2 = jnp.sum(r2 * z2)
        beta = jnp.where(jnp.abs(rz) > 1e-20, rz2 / rz, 0.0)
        p2 = z2 + beta * p
        live = jnp.sqrt(jnp.sum(r2 * r2)) > 1e-7 * jnp.sqrt(jnp.sum(b * b))
        keep = lambda new, old: jnp.where(live, new, old)  # noqa: E731
        return (keep(x2, x), keep(r2, res), keep(p2, p),
                keep(rz2, rz)), None

    (dx_p, _, _, _), _ = jax.lax.scan(
        cg_body, (x, res, p, rz), None, length=cg_iters)
    dx_p = jnp.where(fp[:, None], 0.0, dx_p)

    back_f = jnp.einsum("fki,fk->fi", Hpl_f, dx_p[prob.kf_idx])
    back = jnp.einsum("mo,moi->mi", vmf, back_f[fidx])
    dx_l = jnp.einsum("mij,mj->mi", Hll_inv, -gl - back)
    dx_l = jnp.where(prob.fixed_point[:, None], 0.0, dx_l)

    new_poses = lie.se3_boxplus(poses, dx_p)
    new_points = points + dx_l
    seen = dict(r=r, Jp=Jp, Jl=Jl, Hll=Hll, gl=gl, Hll_inv=Hll_inv,
                Hpp=Hpp, g_r=g_r, dx_p=dx_p, dx_l=dx_l)
    return new_poses, new_points, seen


@functools.partial(
    jax.jit,
    static_argnames=("cam_model", "iters", "chi2_th", "use_robust",
                     "pose_stride", "cg_iters"))
def lm_chunk_opened(poses, points, lam, cost0, inlier, prob, cam_model,
                    iters, chi2_th, use_robust, pose_stride, cg_iters=64):
    """``jba.lm_chunk`` with ``pose_stride > 0``: the carry (poses,
    points, lam, cost) and, stacked per LM iteration, the step's
    intermediates (``_lm_step_cg_opened``), the state, damping and cost
    it started from (``R``, ``t``, ``X``, ``lam``, ``cost``), the
    candidate (``cR``, ``ct``, ``cX``), its cost ``c1`` and the accept
    decision."""
    th_f = jba._factor_chi2_th(prob, chi2_th)

    def cost_at(ps, pt):
        r, fin = jba._eval_residuals(ps, pt, prob, cam_model)
        return jba._robust_cost(r, prob.inv_sigma2,
                                prob.valid & inlier & fin, th_f)[0]

    def body(carry, _):
        poses, points, lam, cost0 = carry
        cand_poses, cand_points, seen = _lm_step_cg_opened(
            poses, points, lam, inlier, prob, cam_model, chi2_th,
            use_robust, pose_stride, cg_iters)
        cost1 = cost_at(cand_poses, cand_points)
        finite = (jnp.all(jnp.isfinite(cand_poses.t))
                  & jnp.all(jnp.isfinite(cand_poses.R))
                  & jnp.all(jnp.isfinite(cand_points))
                  & jnp.isfinite(cost1))
        accept = (cost1 < cost0) & finite
        out = dict(seen, R=poses.R, t=poses.t, X=points, lam=lam,
                   cost=cost0, cR=cand_poses.R, ct=cand_poses.t, cX=cand_points,
                   c1=cost1, accept=accept)
        poses = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), cand_poses, poses)
        points = jnp.where(accept, cand_points, points)
        lam = jnp.where(accept, jnp.maximum(lam * (1.0 / 3.0), 1e-8),
                        jnp.minimum(lam * 4.0, 1e6))
        cost = jnp.where(accept, cost1, cost0)
        return (poses, points, lam, cost), out

    (poses, points, lam, cost), out = jax.lax.scan(
        body, (poses, points, lam, cost0), None, length=iters)
    return poses, points, lam, cost, out
