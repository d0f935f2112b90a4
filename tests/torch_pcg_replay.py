"""The five PCG iterations of ``test_torch_ba_cg.py::
test_lm_chunk_general_layout[pcg]``, one LM iteration at a time (ROADMAP
C14b)::

    JAX_PLATFORMS=cpu python tests/torch_pcg_replay.py [--pinned]

Both packages run ``lm_chunk`` with one iteration at a time on the test's
problem (16 keyframes x 96 factors, 256 landmarks). Per LM iteration it
prints the reference's damping, cost and candidate cost; how far the port's
candidate lies from the reference's when the port steps from the
reference's own state (carried); and how far the two free-running packages
are apart after it (what the test holds to 5e-4).

Then, from the reference's state before each LM iteration, both packages'
``_lm_step_cg`` with ``cg_iters`` = 1, 2, 4, ..., 64 (the reference's own
argument, jitted): how far apart the two candidates' poses and points are
after k CG iterations, against the size of the step. And the port's CG
scalars of the full 64-iteration solve at that state: ``rz``, ``denom``
(``p . Ap``), ``alpha``, ``beta`` and the residual norm, read off its
``torch.sum`` calls.

Last, the reference's own spread: its state after the test's five
iterations in the parent's library regime against the pinned one.

``--pinned`` runs it all in a child under ``torch_regime.PINNED``. About a
minute each.
"""

import argparse
import os
import sys

import numpy as np

from torch_regime import call_in_regime

CG_ITERS = (0, 1, 2, 4, 8, 16, 32, 64)


def _problems():
    import jax.numpy as jnp
    import torch

    import test_torch_ba_cg as B
    from orb_slam_fusion_tpu import lie as jlie
    from orb_slam_fusion_tpu.solver import ba as jba
    from orb_slam_fusion_tpu_torch import lie as tlie
    from orb_slam_fusion_tpu_torch.solver import ba as tba

    a = B._arrays()
    pj = jba.make_problem(
        jlie.SE3(jnp.asarray(a["R"]), jnp.asarray(a["t"])),
        jnp.asarray(a["pts"]), a["kf_idx"], a["mp_idx"], a["uv"],
        a["inv_s2"], a["valid"], jnp.asarray(a["fixed"]),
        jnp.asarray(B.CAM), max_obs=16)
    T = torch.from_numpy
    pt = tba.make_problem(
        tlie.SE3(T(a["R"]), T(a["t"])), T(a["pts"]), T(a["kf_idx"]),
        T(a["mp_idx"]), T(a["uv"]), T(a["inv_s2"]), T(a["valid"]),
        T(a["fixed"]), T(B.CAM), max_obs=16)
    return pj, pt, B.NF


def _port_state(s):
    """The reference's carry (poses, points, lam, cost) as the port's."""
    import torch

    from orb_slam_fusion_tpu_torch import lie as tlie

    P, X, lam, cost = s
    T = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return (tlie.SE3(T(P.R), T(P.t)), T(X), T(lam), T(cost))


def _apart(ref, port):
    """Largest |difference| of (poses, points): ref a JAX (SE3, points),
    port a torch one."""
    P, X = ref
    Q, Y = port
    dp = max(np.abs(np.asarray(P.R) - Q.R.numpy()).max(),
             np.abs(np.asarray(P.t) - Q.t.numpy()).max())
    return float(dp), float(np.abs(np.asarray(X) - Y.numpy()).max())


def _cg_scalars(fn):
    """Run ``fn`` and read the port's PCG scalars off its ``torch.sum``
    calls: the solve sums ``res . z`` (rz) and ``b . b`` once, then per CG
    iteration ``p . Ap`` (denom), ``r2 . z2`` (rz2) and ``r2 . r2``."""
    import torch
    from torch.overrides import TorchFunctionMode

    sums = []

    class Rec(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.sum and out.dim() == 0:
                sums.append(float(out))
            return out

    with Rec():
        fn()
    # the step's earlier scalar sums come first; the solve's are the last
    # 2 + 3 * 64
    s = sums[-(2 + 3 * 64):]
    rz, rows = s[0], []
    for i in range(64):
        denom, rz2, rr = s[2 + 3 * i: 5 + 3 * i]
        alpha = rz / denom if abs(denom) > 1e-20 else 0.0
        beta = rz2 / rz if abs(rz) > 1e-20 else 0.0
        rows.append((i, rz, denom, alpha, beta, float(np.sqrt(rr))))
        rz = rz2
    return rows


def replay(lm_iters: int = 5):
    """The rows printed by ``main`` (see the module docstring)."""
    import functools

    import jax
    import jax.numpy as jnp
    import torch

    from orb_slam_fusion_tpu.solver import ba as jba
    from orb_slam_fusion_tpu_torch.solver import ba as tba

    torch.set_num_threads(2)
    pj, pt, nf = _problems()
    inl_j, inl_t = jnp.ones_like(pj.valid), torch.ones_like(pt.valid)
    args = ("pinhole", 1, 5.991, True, nf)
    sj = (pj.poses, pj.points, jnp.float32(1e-4),
          jba.lm_cost(pj.poses, pj.points, inl_j, pj, "pinhole"))
    st = (pt.poses, pt.points, torch.tensor(1e-4),
          tba.lm_cost(pt.poses, pt.points, inl_t, pt, "pinhole"))
    step_j = jax.jit(functools.partial(
        jba._lm_step_cg, prob=pj, cam_model="pinhole", chi2_th=5.991,
        use_robust=True, pose_stride=nf), static_argnames=("cg_iters",))
    lm_rows, cg_rows, scalars = [], [], []
    for it in range(lm_iters):
        carried = _port_state(sj)
        for k in CG_ITERS:
            cj = step_j(sj[0], sj[1], sj[2], inl_j, cg_iters=k)
            ct = tba._lm_step_cg(carried[0], carried[1], carried[2], inl_t,
                                 pt, "pinhole", 5.991, True, nf,
                                 cg_iters=k)
            step = max(float(np.abs(np.asarray(cj[0].t)
                                    - np.asarray(sj[0].t)).max()),
                       float(np.abs(np.asarray(cj[1])
                                    - np.asarray(sj[1])).max()))
            cg_rows.append((it, k) + _apart(cj[:2], ct[:2]) + (step,))
        scalars.append((it, _cg_scalars(lambda: tba._lm_step_cg(
            carried[0], carried[1], carried[2], inl_t, pt, "pinhole", 5.991,
            True, nf))))
        nj = jba.lm_chunk(*sj, inl_j, pj, *args)
        nc = tba.lm_chunk(*carried, inl_t, pt, *args)
        nt = tba.lm_chunk(*st, inl_t, pt, *args)
        lm_rows.append((it, float(nj[2]), float(nj[3]), float(nj[4][0]))
                       + _apart(nj[:2], nc[:2]) + (float(nc[4][0]),)
                       + _apart(nj[:2], nt[:2]))
        sj, st = nj[:4], nt[:4]
    return dict(lm=lm_rows, cg=cg_rows, scalars=scalars)


def reference_chunk(lm_iters: int = 5):
    """The reference's state after the test's ``lm_chunk`` (five PCG
    iterations at once): rotations, translations and points as numpy."""
    import jax.numpy as jnp

    from orb_slam_fusion_tpu.solver import ba as jba

    pj, _, nf = _problems()
    inl = jnp.ones_like(pj.valid)
    c0 = jba.lm_cost(pj.poses, pj.points, inl, pj, "pinhole")
    P, X = jba.lm_chunk(pj.poses, pj.points, jnp.float32(1e-4), c0, inl, pj,
                        "pinhole", lm_iters, 5.991, True, nf)[:2]
    return np.asarray(P.R), np.asarray(P.t), np.asarray(X)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pinned", action="store_true",
                    help="run under torch_regime.PINNED in a child")
    a = ap.parse_args()
    if a.pinned:
        out = call_in_regime("torch_pcg_replay:replay")
    else:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_threefry_partitionable", True)
        out = replay()
    print("regime:", "pinned" if a.pinned else "the parent's")
    here = call_in_regime("torch_pcg_replay:reference_chunk",
                          env={} if not a.pinned else None)
    other = call_in_regime("torch_pcg_replay:reference_chunk",
                           env=None if not a.pinned else {})
    print("the reference's own spread after the test's five iterations, "
          "pinned against the parent's regime: rotation %.3e, translation "
          "%.3e, points %.3e" % tuple(
              float(np.abs(x - y).max()) for x, y in zip(here, other)))
    print("LM it | ref lam, cost, candidate | carried: port-ref pose, point,"
          " port candidate | free: pose, point")
    for it, lam, cost, cand, cp, cx, ccand, fp, fx in out["lm"]:
        print(f"{it:5d} | {lam:.3e} {cost:.6f} {cand:.6f} | {cp:.3e} "
              f"{cx:.3e} {ccand:.6f} | {fp:.3e} {fx:.3e}")
    print("LM it, CG its | port-ref pose, point | step size")
    for it, k, dp, dx, step in out["cg"]:
        print(f"{it:5d} {k:3d} | {dp:.3e} {dx:.3e} | {step:.3e}")
    print("LM it | port CG scalars at CG it 0, 1, 2, 3, 63: rz, denom,"
          " alpha, beta, |r|")
    for it, rows in out["scalars"]:
        for i, rz, denom, alpha, beta, rn in [rows[j] for j in
                                              (0, 1, 2, 3, 63)]:
            print(f"{it:5d} {i:3d} | {rz:.7e} {denom:.7e} {alpha:.7e} "
                  f"{beta:.7e} {rn:.7e}")
    sys.stdout.flush()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
