"""The library regime the CPU parity tests pin (ROADMAP C13, hazard H6).

Both packages' float results on the CPU depend on kernels that a library
picks by the host's CPU when it loads, not on the code of either package:

* the reference's linear algebra (``jax.scipy.linalg``, ``jnp.linalg`` on
  the CPU) calls LAPACK through scipy's OpenBLAS, which loads at the first
  such call and picks a core type (``SkylakeX`` on an AVX-512 host,
  ``Haswell`` on an AVX2 one, ...), each with its own kernels;
* the port's ``torch.linalg`` on the CPU calls MKL, whose code path
  depends on the vendor and features of the CPU unless its conditional
  numerical reproducibility (``MKL_CBWR``) is set.

Where a comparison sits within one rounding of its tolerance (an LM accept
decision on a flat cost, a chi2 gate, a free-running session), the host
then decides whether it passes. ``PINNED`` fixes both libraries to kernels
that every x86-64 host with AVX2 and FMA runs alike: OpenBLAS's Haswell
core, and MKL's ``COMPATIBLE`` branch (MKL documents it to give the same
results on Intel and non-Intel processors). The XLA:CPU code generation is
not pinned: the port's resize restates it for an AVX-512 host (C3).

The variables must be set before either library loads, and a test process
may have loaded both already (pytest-xdist runs many files per worker), so
a pinned test runs in a child interpreter:

* ``@pinned`` (above any ``parametrize``) runs the module's pinned tests in
  one child ``pytest`` under ``PINNED`` and reports each test's own outcome
  in the parent; their fixtures are built only in the child.
* ``call_in_regime("module:function", *args, env=...)`` calls a function of
  ``tests/`` in a child under ``env`` (default ``PINNED``), with JAX set up
  as ``tests/conftest.py`` sets it, and returns its (picklable) result.
* ``library_regime()`` reads back what a process runs: the core type of
  each OpenBLAS loaded (``threadpoolctl``) and MKL's CNR branch.
"""

import functools
import inspect
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

PINNED = {"OPENBLAS_CORETYPE": "Haswell", "MKL_CBWR": "COMPATIBLE"}
# MKL's code for the COMPATIBLE branch (mkl_cbwr_get's MKL_CBWR_COMPATIBLE)
MKL_CBWR_COMPATIBLE = 3
CHILD = "ORB_SLAM_PINNED_CHILD"
TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
CHILD_TIMEOUT = 900          # seconds for one child (a module's sessions)

# the outcomes one child recorded, per test file (one child a file and
# process: pytest-xdist's --dist loadfile keeps a file on one worker)
_results = {}                # module file -> {test name: (outcome, text)}


def in_child() -> bool:
    return os.environ.get(CHILD) == "1"


def child_env(env=None) -> dict:
    out = dict(os.environ)
    out.update(PINNED if env is None else env)
    out[CHILD] = "1"
    return out


def library_regime() -> dict:
    """The OpenBLAS core types and MKL branch this process runs. Loads
    scipy's and numpy's OpenBLAS (as the reference's first ``jnp.linalg``
    call would) and calls MKL once through torch."""
    import ctypes

    import numpy as np
    import scipy.linalg
    import threadpoolctl
    import torch

    scipy.linalg.cho_factor(np.eye(2))
    np.linalg.cholesky(np.eye(2))
    torch.linalg.cholesky(torch.eye(2, dtype=torch.float64))
    openblas = {pathlib.Path(d["filepath"]).name: d.get("architecture")
                for d in threadpoolctl.threadpool_info()
                if d.get("internal_api") == "openblas"}
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    cbwr_get = lib.mkl_serv_cbwr_get       # MKL's mkl_cbwr_get, in torch
    cbwr_get.argtypes, cbwr_get.restype = [ctypes.c_int], ctypes.c_int
    return dict(openblas=openblas, mkl_cbwr=cbwr_get(1))   # MKL_CBWR_BRANCH


# ---------------------------------------------------------------------------
# a function in a child
# ---------------------------------------------------------------------------


def call_in_regime(target: str, *args, env=None, **kwargs):
    """``module:function`` of ``tests/`` called in a child interpreter under
    ``env`` (``PINNED`` by default); returns its result."""
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "call.pkl"), os.path.join(d, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump((target, args, kwargs), f)
        p = subprocess.run([sys.executable, __file__, src, dst],
                           env=child_env(env), cwd=ROOT, capture_output=True,
                           text=True, timeout=CHILD_TIMEOUT)
        if p.returncode != 0:
            raise RuntimeError(f"{target} failed in the child "
                               f"(rc {p.returncode}):\n{p.stderr[-4000:]}")
        with open(dst, "rb") as f:
            return pickle.load(f)


def _serve(src: str, dst: str) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    sys.path[:0] = [str(TESTS), str(ROOT)]
    import importlib

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    with open(src, "rb") as f:
        target, args, kwargs = pickle.load(f)
    module, name = target.split(":")
    out = getattr(importlib.import_module(module), name)(*args, **kwargs)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# tests in a child
# ---------------------------------------------------------------------------


def pinned(fn):
    """Run this test under ``PINNED``: in the parent, a wrapper that takes
    only the test's ``parametrize`` arguments (so no fixture is built
    there) and reports the outcome the child recorded for this test; in
    the child, the test itself."""
    if in_child():
        return fn
    names = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            argnames = mark.args[0]
            names += ([n.strip() for n in argnames.split(",")]
                      if isinstance(argnames, str) else list(argnames))

    @functools.wraps(fn)
    def in_regime(**_params):
        _report(sys.modules[fn.__module__])

    del in_regime.__wrapped__
    in_regime.__signature__ = inspect.Signature(
        [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
         for n in names])
    in_regime.pinned_test = True
    return in_regime


def _report(module) -> None:
    import pytest

    path = pathlib.Path(module.__file__).resolve()
    if path not in _results:
        _results[path] = _run_child(module, path)
    name = os.environ["PYTEST_CURRENT_TEST"].rsplit(" ", 1)[0]
    name = name.split("::")[-1]
    outcome, text = _results[path].get(name, ("missing", ""))
    if outcome == "skipped":
        pytest.skip(text)
    if outcome != "passed":
        pytest.fail(f"{name} under {PINNED} in a child: {outcome}\n{text}",
                    pytrace=False)


def _run_child(module, path) -> dict:
    tests = sorted(k for k, v in vars(module).items()
                   if getattr(v, "pinned_test", False))
    rel = path.relative_to(ROOT)
    with tempfile.TemporaryDirectory() as d:
        xml = os.path.join(d, "child.xml")
        cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
               "-p", "no:xdist", "-p", "no:randomly", f"--junitxml={xml}",
               *[f"{rel}::{t}" for t in tests]]
        try:
            p = subprocess.run(cmd, env=child_env(), cwd=ROOT,
                               capture_output=True, text=True,
                               timeout=CHILD_TIMEOUT)
            log = p.stdout[-6000:] + p.stderr[-2000:]
        except subprocess.TimeoutExpired as e:
            log = f"child timed out after {e.timeout} s"
        if not os.path.exists(xml):
            return {t: ("child did not report", log) for t in tests}
        out = {}
        for case in ET.parse(xml).getroot().iter("testcase"):
            outcome, text = "passed", ""
            for tag in ("failure", "error", "skipped"):
                node = case.find(tag)
                if node is not None:
                    outcome = "skipped" if tag == "skipped" else tag
                    text = (node.get("message") or "") + "\n" + (
                        node.text or "")
                    break
            out[case.get("name")] = (outcome, text)
        return out


if __name__ == "__main__":
    _serve(*sys.argv[1:3])
