"""The VIBA1 keyframe step of ``test_torch_vio_mono_session.py``, solver by
solver (ROADMAP C14)::

    JAX_PLATFORMS=cpu python tests/torch_viba1_replay.py [--upper]

In the pinned library regime (children under ``torch_regime.PINNED``) and
from one carried state (the reference's just before the VIBA1 keyframe),
both packages step that frame with their ``VioTracker``'s
``visual_inertial_ba`` and ``inertial_init`` wrapped to record each call:
the windowed VI-BA, the scale-estimating inertial init, the full VI-BA.
The port also calls each solver again on the arguments the reference's
call was given, and its full VI-BA once more in float64 on them. Prints,
per call, how far apart the two packages' positions are in its arguments
and its solution (a VI-BA's positions, an init's scale and velocities),
the port's solution from the reference's arguments, and the LM candidate
costs of each run (``nan``: a candidate whose Cholesky factorization
failed).
``--upper`` makes the port's Cholesky read the upper triangle of each
system, as the reference's ``solve(assume_a="pos")`` does, instead of the
lower one. About a minute.
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


def _upper_triangle():
    """The port's ``solve_pos`` reading the upper triangle of H."""
    import torch

    import orb_slam_fusion_tpu_torch.solver.vi_ba as tvi

    def solve_pos(H, g):
        L, info = torch.linalg.cholesky_ex(H.mT)
        x = torch.cholesky_solve(g.unsqueeze(-1), L).squeeze(-1)
        return torch.where(info == 0, x, torch.full_like(x, float("nan")))

    tvi.solve_pos = solve_pos


def record(package, snapshot, reference_log=None, upper=False):
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
        if upper:
            _upper_triangle()
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--upper", action="store_true",
                    help="the port's Cholesky reads the upper triangle")
    a = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "viba1.pkl")
        call_in_regime("torch_regime_spread:viba1_snapshot", snap)
        ref = call_in_regime("torch_viba1_replay:record", "reference", snap)
        ref_path = os.path.join(tmp, "reference.pkl")
        with open(ref_path, "wb") as f:
            pickle.dump(ref, f)
        port = call_in_regime("torch_viba1_replay:record", "port", snap,
                              ref_path, a.upper)
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


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
