"""The VIBA1 keyframe step of ``test_torch_vio_mono_session.py``, solver by
solver (ROADMAP C14)::

    JAX_PLATFORMS=cpu python tests/torch_viba1_replay.py [--lower]
        [--keep DIR] [--write-golden]

In the pinned library regime (children under ``torch_regime.PINNED``) and
from one carried state (the reference's just before the VIBA1 keyframe),
both packages step that frame with their ``VioTracker``'s
``visual_inertial_ba`` and ``inertial_init`` wrapped to record each call:
the windowed VI-BA, the scale-estimating inertial init, the full VI-BA.
The port also calls each solver again on the arguments the reference's
call was given, and its full VI-BA once more in float64 on them. Prints,
per call, how far apart the two packages' positions are in its arguments
and its solution (a VI-BA's positions, an init's scale and velocities),
the port's solution from the reference's arguments, the LM candidate
costs of each run (``nan``: a candidate whose Cholesky factorization
failed), and the first quantity that differs from the reference's
arguments, in the order the solver computes them: for a VI-BA the
inertial factors' residuals and Jacobians, the inertial normal system
summed from the reference's own factor blocks, then the candidate costs
and the accept decisions; for the init the residuals and Jacobian, each
iteration's normal equations from the reference's own Jacobian, the step
solved from the reference's own system, then the candidates and
decisions (``torch_vi_ba_reference.py`` opens the reference's programs).
``--lower`` makes the port's VI solvers factor the lower triangle of each
system (``solve_pos`` as it stands for the other solvers) instead of the
upper one, which the reference factors. ``--keep DIR`` keeps
the reference's snapshot and recorded calls in DIR (outside the repo) and
reuses them on the next run. ``--write-golden`` writes the init's and the
full VI-BA's recorded arguments and results, with the port's results from
those arguments on the CPU, to ``torch_goldens/viba1_solver_calls.npz``
(``test_torch_vi_ba_order.py`` and ``chip_smoke.py`` read it). About 2
minutes on the CPU (the reference's snapshot and step most of it); about
35 s with ``--keep`` after the first run.
"""

import argparse
import dataclasses
import os
import pickle
import sys
import tempfile

import numpy as np

from torch_regime import call_in_regime

CALLS = ("visual_inertial_ba", "inertial_init")


def _numpy(x):
    """A solver's arguments or results as nested dicts and lists of numpy
    arrays (named tuples and dataclasses by field)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().numpy().copy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _numpy(getattr(x, f)) for f in x._fields}
    if dataclasses.is_dataclass(x):
        return {f.name: _numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_numpy(v) for v in x]
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if type(x).__module__.startswith("jax"):
        return np.asarray(x)
    return x


def _like(x, r, dtype=None):
    """``x`` (the port's argument) with every tensor replaced by the
    reference's recorded array ``r`` at the same place, cast to ``x``'s
    dtype or to ``dtype`` for floating tensors."""
    import torch

    if isinstance(x, torch.Tensor):
        cast = dtype is not None and x.is_floating_point()
        return torch.from_numpy(np.asarray(r)).to(dtype if cast else x.dtype)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_like(getattr(x, f), r[f], dtype)
                         for f in x._fields])
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _like(getattr(x, f.name), r[f.name], dtype)
            for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_like(v, rv, dtype) for v, rv in zip(x, r))
    if isinstance(x, dict):
        return {k: _like(v, r[k], dtype) for k, v in x.items()}
    return x


def _lower_triangle():
    """The port's VI solvers factoring the lower triangle of H."""
    import orb_slam_fusion_tpu_torch.solver.vi_ba as tvi

    tvi._solve_upper = tvi.solve_pos


def record(package, snapshot, reference_log=None, lower=False):
    """Step the VIBA1 keyframe with ``package``'s solvers recorded; the
    port also replays each call on the reference's arguments."""
    import torch

    import test_torch_helpers as h
    import test_torch_vio_mono_session as m
    import torch_regime_spread as sp
    import torch_vio_cases as cases
    from orb_slam_fusion_tpu_torch.map import convert

    if package == "reference":
        import orb_slam_fusion_tpu.engine.vio_tracker as mod
    else:
        import orb_slam_fusion_tpu_torch.engine.vio_tracker as mod
        if lower:
            _lower_triangle()
    ref_log = None
    if reference_log:
        with open(reference_log, "rb") as f:
            ref_log = pickle.load(f)["calls"]
    calls = []
    for name in CALLS:
        def wrap(*args, _solver=getattr(mod, name), _name=name, **kw):
            entry = dict(name=_name, args=_numpy([args, kw]))
            if ref_log is not None:
                ra, rk = ref_log[len(calls)]["args"]
                a2, k2 = _like(list(args), ra), _like(kw, rk)
                entry["replay"] = _numpy(_solver(*a2, **k2))
                if _name == "visual_inertial_ba" and len(calls) == 2:
                    a64 = _like(list(args), ra, torch.float64)
                    k64 = _like(kw, rk, torch.float64)
                    entry["replay64"] = _numpy(_solver(*a64, **k64))
            out = _solver(*args, **kw)
            entry["result"] = _numpy(out)
            calls.append(entry)
            return out
        setattr(mod, name, wrap)

    with open(snapshot, "rb") as f:
        k, tr = pickle.load(f)
    step_ref, step_port = sp._vio_steps(m)

    def go():
        if package == "reference":
            step_ref(tr, k)
        else:
            port = m.VioTracker(
                m.SlamConfig(orb=m.OrbParams(n_features=512), **m.KW),
                m.make_calib(device="cpu"), device="cpu")
            convert.tracker_state_from_numpy(port, h.jax_tracker_state(tr))
            step_port(port, k)

    cases.with_threads(m.THREADS, go)
    return dict(calls=calls)


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(x, np.ndarray) and x.dtype.kind == "f":
        yield path, x


def _largest(a, b, tail=".t") -> str:
    """The largest difference of the positions (leaves named ``tail``)."""
    d = max((float(np.nanmax(np.abs(x.astype(np.float64) - y)))
             for (path, x), (_, y) in zip(_leaves(a), _leaves(b))
             if path.endswith(tail) and x.size
             and not np.isnan(x - y).all()), default=0.0)
    return f"{d:.3g}"


def _solution(result, name):
    """The positions of a VI-BA, the scale and velocities of an init."""
    if name == "inertial_init":
        return [result[0], result[3]]
    return result[0]["poses"]["t"]


def _costs(result, name):
    return np.asarray(result[4] if name == "inertial_init" else result[2])


def _decisions(costs):
    """Each LM candidate's accept decision (``c1 < best so far``)."""
    out, best = [], np.inf
    for c in np.asarray(costs, np.float64):
        ok = bool(np.isfinite(c) and c < best)
        out.append(ok)
        best = c if ok else best
    return out


def _first(a, b):
    """The first index where two sequences differ, or None."""
    for k, (x, y) in enumerate(zip(a, b)):
        if not (x == y or (x != x and y != y)):
            return k
    return None


def _bits(a, b) -> str:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    n = int((a.view(np.int32) != b.view(np.int32)).sum())
    return "equal" if n == 0 else f"{n} of {a.size} differ"


def diagnose(reference_log):
    """Per call, from the reference's arguments: the port's and the
    reference's quantities in the order the solver computes them (run in
    a pinned child: imports both packages)."""
    import jax
    import jax.numpy as jnp
    import torch

    import orb_slam_fusion_tpu.solver.vi_ba as jvi
    import orb_slam_fusion_tpu_torch.solver.vi_ba as tvi
    import torch_vi_ba_reference as jref
    import torch_vio_problems as vp
    from orb_slam_fusion_tpu.imu.preintegration import GRAVITY
    from orb_slam_fusion_tpu_torch.imu.preintegration import gravity_vec

    with open(reference_log, "rb") as f:
        calls = pickle.load(f)["calls"]
    lines = []
    for n, c in enumerate(calls):
        name = "init" if c["name"] == "inertial_init" else "vi_ba"
        entry = dict(args=vp.unflatten(vp.flatten(c["args"])))
        (a, kw) = vp.viba1_args(entry, "cpu")
        if name == "vi_ba":
            state, _, ifac, calib = a
            ja, _ = _jax_args(c)
            js, jf, jc = ja[0], ja[2], ja[3]
            gw = jnp.array([0.0, 0.0, -GRAVITY], jnp.float32)
            rj = [np.asarray(x) for x in jref.inertial_blocks(js, jf, jc,
                                                              gw)]
            rt = [x.numpy() for x in tvi._inertial_blocks(
                state, ifac, calib, gravity_vec("cpu", torch.float32))]
            lines.append(f"call {n} {name}: factor blocks r "
                         f"{_bits(rt[0], rj[0])}, Ji {_bits(rt[1], rj[1])},"
                         f" Jj {_bits(rt[2], rj[2])}")
            args5 = (1e4, 1e2, 1e4, 1e2)
            Hj, gj = jax.jit(jvi.inertial_system)(js, jf, jc, gw, *args5)
            Ht, gt = tvi.inertial_normal_equations(
                state, ifac, *[torch.from_numpy(x) for x in rj], *args5)
            lines.append(f"  inertial system from the reference's blocks: "
                         f"H {_bits(Ht.numpy(), Hj)}, "
                         f"g {_bits(gt.numpy(), gj)}")
        else:
            _, ifac, _ = a
            ja, jkw = _jax_args(c)
            it = {k: np.asarray(v) for k, v in
                  jref.init_iterations(*ja, **jkw).items()}
            rt, Jt = _init_linearization(a, kw)
            lines.append(f"call {n} {name}: residual {_bits(rt, it['r'][0])},"
                         f" Jacobian {_bits(Jt, it['J'][0])} (iteration 0)")
            prior = torch.tensor([kw["prior_g"]] * 3 + [kw["prior_a"]] * 3)
            same, step = 0, 0.0
            for k in range(len(it["c1"])):
                H, g = tvi._init_normal_equations(
                    torch.from_numpy(it["J"][k]), torch.from_numpy(it["r"][k]),
                    ifac.info, prior, torch.from_numpy(it["theta"][k]),
                    torch.tensor(it["lam"][k]))
                same += (_bits(H.numpy(), it["H"][k]) == "equal"
                         and _bits(g.numpy(), it["gvec"][k]) == "equal")
                dx = -tvi._solve_upper(torch.from_numpy(it["H"][k]),
                                       torch.from_numpy(it["gvec"][k]))
                step = max(step, float(np.abs(dx.numpy() - it["dx"][k]).max()))
            lines.append(f"  normal equations from the reference's Jacobian:"
                         f" {same} of {len(it['c1'])} iterations equal; step "
                         f"from the reference's system: up to {step:.3g} off"
                         f" (the Cholesky factorization, class (b))")
        want = _costs(c["result"], c["name"])
        lines.append(f"  first differing candidate: "
                     f"{_first(want, c['replay'])}, first differing accept "
                     f"decision: "
                     f"{_first(_decisions(want), _decisions(c['replay']))}")
    return "\n".join(lines)


def _jax_args(c):
    """The reference's own (args, kwargs) of a recorded call."""
    import jax.numpy as jnp

    import orb_slam_fusion_tpu.solver.vi_ba as jvi
    from orb_slam_fusion_tpu import lie
    from orb_slam_fusion_tpu.imu import preintegration as jp
    from orb_slam_fusion_tpu.solver import ba as jba

    nested = {"poses": lie.SE3, "pre": jp.Preintegrated, "bias0": jp.ImuBias}

    def tree(cls, d):
        return cls(**{f: (tree(nested[f], d[f]) if isinstance(d[f], dict)
                          else None if d[f] is None else jnp.asarray(d[f]))
                      for f in cls._fields if f in d})

    args, kw = c["args"]
    if c["name"] == "inertial_init":
        return (tree(lie.SE3, args[0]),
                tree(jvi.InertialFactorBatch, args[1]),
                tree(jp.ImuCalib, args[2])), kw
    return (tree(jvi.VIState, args[0]), tree(jba.BAProblem, args[1]),
            tree(jvi.InertialFactorBatch, args[2]),
            tree(jp.ImuCalib, args[3])), kw


def _init_linearization(a, kw):
    """The port's init residual and Jacobian at its start (theta = 0),
    caught where ``inertial_init`` hands them to its normal equations."""
    import orb_slam_fusion_tpu_torch.solver.vi_ba as tvi

    seen = {}
    orig = tvi._init_normal_equations

    def spy(Jb, r, *rest):
        seen.setdefault("r", r.numpy().copy())
        seen.setdefault("J", Jb.numpy().copy())
        return orig(Jb, r, *rest)

    tvi._init_normal_equations = spy
    try:
        tvi.inertial_init(*a, **dict(kw, iters=1))
    finally:
        tvi._init_normal_equations = orig
    return seen["r"], seen["J"]


def port_golden(golden_path):
    """The port's results from the golden's recorded arguments, on the
    CPU (pinned child)."""
    import torch

    import orb_slam_fusion_tpu_torch.solver.vi_ba as tvi
    import torch_vio_problems as vp

    torch.set_num_threads(2)
    g = vp.load_viba1_golden(golden_path)
    out = {}
    for tag, fn in (("init", tvi.inertial_init),
                    ("full", tvi.visual_inertial_ba)):
        a, kw = vp.viba1_args(g[tag], "cpu")
        out[tag] = _numpy(fn(*a, **kw))
    return out


def write_golden(ref):
    """The init's and the full VI-BA's recorded calls, and the port's
    results from their arguments, to ``torch_goldens``."""
    import torch_vio_problems as vp

    calls = dict(zip(vp.VIBA1_CALLS, ref["calls"][1:3]))
    flat = {}
    for tag, c in calls.items():
        flat.update(vp.flatten(dict(args=c["args"], result=c["result"]),
                               f"{tag}/"))
    np.savez_compressed(vp.VIBA1_GOLDEN, **flat)
    port = call_in_regime("torch_viba1_replay:port_golden",
                          str(vp.VIBA1_GOLDEN))
    for tag in vp.VIBA1_CALLS:
        flat.update(vp.flatten(port[tag], f"{tag}/port_cpu/"))
    np.savez_compressed(vp.VIBA1_GOLDEN, **flat)
    return vp.VIBA1_GOLDEN


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lower", action="store_true",
                    help="the port's VI solvers factor the lower triangle")
    ap.add_argument("--keep", metavar="DIR",
                    help="keep (and reuse) the reference's snapshot and "
                    "recorded calls in DIR, outside the repo")
    ap.add_argument("--write-golden", action="store_true",
                    help="write torch_goldens/viba1_solver_calls.npz")
    a = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        keep = a.keep or tmp
        os.makedirs(keep, exist_ok=True)
        snap = os.path.join(keep, "viba1.pkl")
        ref_path = os.path.join(keep, "reference.pkl")
        if not os.path.exists(snap):
            call_in_regime("torch_regime_spread:viba1_snapshot", snap)
        if os.path.exists(ref_path):
            with open(ref_path, "rb") as f:
                ref = pickle.load(f)
        else:
            ref = call_in_regime("torch_viba1_replay:record", "reference",
                                 snap)
            with open(ref_path, "wb") as f:
                pickle.dump(ref, f)
        port = call_in_regime("torch_viba1_replay:record", "port", snap,
                              ref_path, a.lower)
        replays = dict(calls=[dict(r, replay=_costs(p["replay"], r["name"]))
                              for r, p in zip(ref["calls"], port["calls"])])
        diag_path = os.path.join(tmp, "replays.pkl")
        with open(diag_path, "wb") as f:
            pickle.dump(replays, f)
        report = call_in_regime("torch_viba1_replay:diagnose", diag_path)
        if a.write_golden:
            print(f"wrote {write_golden(ref)}")
    np.set_printoptions(precision=8, linewidth=160)
    for i, (r, p) in enumerate(zip(ref["calls"], port["calls"])):
        name = r["name"]
        print(f"== call {i}: {name}")
        print(f"  positions in the arguments, port - reference: "
              f"{_largest(p['args'], r['args'])}")
        sol = lambda e: _solution(e, name)                # noqa: E731
        print(f"  solution, port - reference: "
              f"{_largest(sol(p['result']), sol(r['result']), '')}")
        print(f"  solution, port from the reference's arguments - reference: "
              f"{_largest(sol(p['replay']), sol(r['result']), '')}")
        print(f"  candidates, reference: {_costs(r['result'], name)}")
        print(f"  candidates, port from the reference's arguments: "
              f"{_costs(p['replay'], name)}")
        if "replay64" in p:
            print(f"  solution, reference - port in float64 from the "
                  f"reference's arguments: "
                  f"{_largest(sol(r['result']), sol(p['replay64']), '')}")
            print(f"  candidates, port in float64: "
                  f"{_costs(p['replay64'], name)}")
    print("== first differing quantities, from the reference's arguments")
    print(report)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
