"""The five PCG iterations of ``test_torch_ba_cg.py::
test_lm_chunk_general_layout[pcg]``, one LM iteration at a time (ROADMAP
C14b)::

    JAX_PLATFORMS=cpu python tests/torch_pcg_replay.py [--pinned]
        [--keep DIR] [--write-golden]

First the first-difference report. The reference's ``lm_chunk`` runs the
test's five iterations as one program (``torch_pcg_reference.
lm_chunk_opened``, the copy that returns its intermediates, held to
``jba.lm_chunk`` bit for bit). For each LM iteration the port steps from
the reference's own state, stage by stage in the order the step computes
them, each stage from the reference's own inputs to it: the factors
(``r``, ``Jp``, ``Jl``), the landmark system (``Hll``, ``gl``,
``Hll_inv``), the pose system (``Hpp``, ``g_r``), the landmark step with
``cg_iters=0`` (against the reference's ``_lm_step_cg`` jitted with it),
the landmark step from the reference's pose step; then, not bit for bit,
the pose step after the 64 CG iterations (the preconditioner is factored
in float64 and by another library, ROADMAP C9), the candidate and the
accept decision. It prints how many values of each stage differ and the
first stage that does.

Then, per LM iteration: the reference's damping, cost and candidate cost;
how far the port's candidate lies from the reference's when the port steps
from the reference's state (carried); how far the two free-running
packages are apart after it (what the test holds to 5e-4). From the
reference's state before each LM iteration, both packages'
``_lm_step_cg`` with ``cg_iters`` = 0, 1, 2, 4, ..., 64: how far apart the
two candidates are after k CG iterations, against the size of the step.
The port's CG scalars of the full solve at that state: ``rz``, ``denom``
(``p . Ap``), ``alpha``, ``beta`` and the residual norm. Last, the
reference's own spread: its state after the test's five iterations in the
parent's library regime against the pinned one.

``--pinned`` runs it all in a child under ``torch_regime.PINNED``.
``--keep DIR`` writes XLA:CPU's compiled programs of the run to DIR
(outside the repo; ``--xla_dump_to``): ``lm_chunk``'s optimized HLO at
the test's static arguments (``*jit_lm_chunk.cpu_after_optimizations.txt``)
with its LLVM IR and object files, which the port's order is read off.
``--write-golden`` writes ``torch_goldens/pcg_linearization.npz``
(``torch_fixtures.PCG_GOLDEN``): the reference's states at two LM
iterations and the host port's sums from them, which must be the
reference's (``test_torch_pcg_order.py``, ``chip_smoke.py``). About a
minute.
"""

import argparse
import json
import os
import sys

import numpy as np

from torch_regime import call_in_regime

CG_ITERS = (0, 1, 2, 4, 8, 16, 32, 64)
STAGES = (("factors", ("r", "Jp", "Jl")),
          ("landmark system", ("Hll", "gl", "Hll_inv")),
          ("pose system", ("Hpp", "g_r")),
          ("landmark step, cg_iters=0", ("cg0_X",)),
          ("landmark step from the reference's pose step", ("dx_l",)))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _differ(got, want) -> int:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return int((got.view(np.int32) != want.view(np.int32)).sum())


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


def opened_run(pj, nf, lm_iters=5):
    """The reference's ``lm_chunk`` at the test's static arguments through
    the opened copy: its intermediates per LM iteration, as numpy."""
    import jax.numpy as jnp

    import torch_pcg_reference as jref
    from orb_slam_fusion_tpu.solver import ba as jba

    inl = jnp.ones_like(pj.valid)
    c0 = jba.lm_cost(pj.poses, pj.points, inl, pj, "pinhole")
    out = jref.lm_chunk_opened(pj.poses, pj.points, jnp.float32(1e-4), c0,
                               inl, pj, "pinhole", lm_iters, 5.991, True, nf)
    return {k: np.asarray(v) for k, v in out[4].items()}


def first_differences(pj, pt, nf, seen):
    """Per LM iteration of the opened run ``seen``: {stage quantity:
    values that differ}, the first stage that differs, the CG's pose step
    and the candidate's distance from the reference's, and whether the
    accept decisions agree."""
    import functools

    import jax
    import jax.numpy as jnp
    import torch

    from orb_slam_fusion_tpu import lie as jlie
    from orb_slam_fusion_tpu.solver import ba as jba
    from orb_slam_fusion_tpu_torch import lie as tlie
    from orb_slam_fusion_tpu_torch.solver import ba as tba

    T = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    step0 = jax.jit(functools.partial(
        jba._lm_step_cg, prob=pj, cam_model="pinhole", chi2_th=5.991,
        use_robust=True, pose_stride=nf, cg_iters=0))
    inl = torch.ones_like(pt.valid)
    rows = []
    for it in range(len(seen["lam"])):
        poses = tlie.SE3(T(seen["R"][it]), T(seen["t"][it]))
        X, lam = T(seen["X"][it]), T(seen["lam"][it])
        r0, Jp0, Jl0 = (T(seen[k][it]) for k in ("r", "Jp", "Jl"))
        r, Jp, Jl, depth_ok = tba._pcg_factors(poses, X, pt, "pinhole")
        w = tba._pcg_weights(r0, pt.valid & depth_ok, pt, 5.991, True)
        Hll, gl, Hll_inv = tba._pcg_landmark_system(r0, Jl0, w, pt, lam)
        Hpp, g_r, Hpl_f = tba._pcg_pose_system(
            r0, Jp0, Jl0, w, T(seen["Hll_inv"][it]), T(seen["gl"][it]), pt,
            nf)
        dx_l = tba._pcg_back_substitute(
            Hpl_f, T(seen["dx_p"][it]), T(seen["Hll_inv"][it]),
            T(seen["gl"][it]), pt)
        cg0_ref = step0(jlie.SE3(jnp.asarray(seen["R"][it]),
                                 jnp.asarray(seen["t"][it])),
                        jnp.asarray(seen["X"][it]),
                        jnp.asarray(seen["lam"][it]),
                        jnp.ones_like(pj.valid))[1]
        cg0 = tba._lm_step_cg(poses, X, lam, inl, pt, "pinhole", 5.991, True,
                              nf, cg_iters=0)[1]
        got = dict(r=r, Jp=Jp, Jl=Jl, Hll=Hll, gl=gl, Hll_inv=Hll_inv,
                   Hpp=Hpp, g_r=g_r, cg0_X=cg0, dx_l=dx_l)
        diff = {k: _differ(v, cg0_ref if k == "cg0_X" else seen[k][it])
                for k, v in got.items()}
        first = next((name for name, keys in STAGES
                      if any(diff[k] for k in keys)), None)
        seen_dx = {}
        boxplus = tba.lie.se3_boxplus

        def spy(T_, xi):
            seen_dx["dx_p"] = xi
            return boxplus(T_, xi)
        tba.lie.se3_boxplus = spy
        try:
            cand = tba._lm_step_cg(poses, X, lam, inl, pt, "pinhole", 5.991,
                                   True, nf)
        finally:
            tba.lie.se3_boxplus = boxplus
        cost = float(tba.lm_cost(*cand[:2], inl, pt, "pinhole"))
        accept = bool(cost < float(seen["cost"][it]) and np.isfinite(cost))
        rows.append(dict(
            it=it, diff=diff, first=first or "(pose step: CG)",
            dx_p=float(np.abs(seen_dx["dx_p"].numpy()
                              - seen["dx_p"][it]).max()),
            dx_p_size=float(np.abs(seen["dx_p"][it]).max()),
            cand_t=float(np.abs(cand[0].t.numpy() - seen["ct"][it]).max()),
            cand_X=float(np.abs(cand[1].numpy() - seen["cX"][it]).max()),
            cost=cost, ref_cost=float(seen["c1"][it]),
            accept_same=accept == bool(seen["accept"][it])))
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
    seen = opened_run(pj, nf, lm_iters)
    report = first_differences(pj, pt, nf, seen)
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
    return dict(report=report, lm=lm_rows, cg=cg_rows, scalars=scalars)


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


def write_golden():
    """``torch_goldens/pcg_linearization.npz`` from this process: the
    reference's states at ``torch_fixtures.PCG_GOLDEN_ITERS`` and the host
    port's sums from them, refused unless those are the reference's."""
    import torch_fixtures as fx
    import test_torch_ba_cg as B

    pj, pt, nf = _problems()
    seen = opened_run(pj, nf)
    g = dict(shape=json.dumps(B.SHAPE), chi2=np.float32(5.991))
    for it in fx.PCG_GOLDEN_ITERS:
        for k in ("R", "t", "X", "lam"):
            g[f"{k}_{it}"] = seen[k][it]
    out = fx.pcg_port_sums(pt, g, "cpu")
    for it in fx.PCG_GOLDEN_ITERS:
        for k in fx.PCG_GOLDEN_SUMS:
            n = _differ(out[f"{k}_{it}"], seen[k][it])
            if n:
                raise RuntimeError(f"{k} at LM iteration {it}: {n} values "
                                   f"differ from the reference's")
    g.update(out)
    path = os.path.join(REPO, "tests", "torch_goldens", fx.PCG_GOLDEN)
    np.savez_compressed(path, **g)
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pinned", action="store_true",
                    help="run under torch_regime.PINNED in a child")
    ap.add_argument("--keep", metavar="DIR",
                    help="write XLA:CPU's compiled programs to DIR")
    ap.add_argument("--write-golden", action="store_true",
                    help="write torch_goldens/pcg_linearization.npz")
    a = ap.parse_args()
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    if a.keep:
        keep = os.path.abspath(a.keep)
        if os.path.commonpath([keep, REPO]) == REPO:
            ap.error("--keep DIR must lie outside the repository")
        os.makedirs(keep, exist_ok=True)
        flags += f" --xla_dump_to={keep} --xla_dump_hlo_as_text"
    os.environ["XLA_FLAGS"] = flags.strip()
    if a.pinned:
        out = call_in_regime("torch_pcg_replay:replay")
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_threefry_partitionable", True)
        out = replay()
        if a.write_golden:
            print("wrote", write_golden())
    print("regime:", "pinned" if a.pinned else "the parent's")
    print("first differences, the port from the reference's own inputs "
          "to each stage (values that differ):")
    for row in out["report"]:
        d = row["diff"]
        print(f"LM it {row['it']}: first differing: {row['first']} | "
              + " ".join(f"{k} {d[k]}" for k in d)
              + f" | pose step {row['dx_p']:.3e} of {row['dx_p_size']:.3e}"
              f", candidate t {row['cand_t']:.3e} X {row['cand_X']:.3e}"
              f", candidate cost {row['cost']:.6f} (reference "
              f"{row['ref_cost']:.6f}), accept decision "
              + ("the same" if row["accept_same"] else "differs"))
    if a.keep:
        hlo = sorted(f for f in os.listdir(keep) if f.endswith(
            "jit_lm_chunk.cpu_after_optimizations.txt"))
        print("lm_chunk's optimized HLO:",
              ", ".join(os.path.join(keep, f) for f in hlo))
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
