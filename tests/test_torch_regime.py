"""The pinned library regime of the CPU parity tests (``torch_regime``,
ROADMAP C13 and H6).

* A child under ``PINNED`` runs OpenBLAS's Haswell core in both OpenBLAS
  builds (numpy's, and scipy's, which the reference's LAPACK calls go
  through) and MKL's COMPATIBLE branch, whatever the parent runs; a child
  given another core type reports that one, so the read-back is not
  vacuous; a ``@pinned`` test body runs in such a child.
* The ChunkedLM window of ``test_torch_capacity.py`` (chunks of 3 and
  5, LAPACK solves in every LM step), its reference run in two children,
  on OpenBLAS's Haswell core (the pinned one) and on its SkylakeX core,
  and the port in the pinned regime: the port's step results, phases,
  remaining iterations and inlier masks equal the reference's on both
  cores, and its poses, positions and points sit inside the reference's
  own spread, that is no farther from the pinned reference than the
  SkylakeX run is. On an AMD EPYC host (chunks of 3): the reference's
  spread 1.43e-5 in rotation, 9.24e-5 in position, 1.08e-3 in points;
  the port 1.8e-7, 6.0e-7 and 4.5e-5 from the pinned reference (with
  MKL's default branch 1.2e-5, 8.1e-5 and 9.4e-4:
  ``tests/torch_regime_spread.py chunked --port-default``). The cost, a
  sum the two packages reduce in other orders, is held by
  ``test_chunked_lm_chunk_by_chunk``. SkylakeX needs AVX-512: without it
  the test skips.
"""

import concurrent.futures

import numpy as np
import pytest

from torch_regime import (MKL_CBWR_COMPATIBLE, PINNED, call_in_regime,
                          in_child, library_regime, pinned)


def _avx512() -> bool:
    try:
        with open("/proc/cpuinfo") as f:
            return " avx512f " in f.read()
    except OSError:
        return False


def test_child_runs_the_pinned_kernels():
    got = call_in_regime("torch_regime:library_regime")
    assert got["openblas"], got
    assert set(got["openblas"].values()) == {PINNED["OPENBLAS_CORETYPE"]}, got
    assert got["mkl_cbwr"] == MKL_CBWR_COMPATIBLE, got


def test_read_back_sees_another_core():
    got = call_in_regime("torch_regime:library_regime",
                         env=dict(PINNED, OPENBLAS_CORETYPE="Nehalem"))
    assert set(got["openblas"].values()) == {"Nehalem"}, got


@pinned
def test_pinned_test_runs_in_the_regime():
    assert in_child()
    got = library_regime()
    assert set(got["openblas"].values()) == {PINNED["OPENBLAS_CORETYPE"]}, got
    assert got["mkl_cbwr"] == MKL_CBWR_COMPATIBLE, got


def chunked_lm_run(package: str, chunk: int = 3) -> list:
    """``test_torch_capacity.py``'s ChunkedLM window run by ``package``
    ("reference" or "port"): per chunk, the step's result, phase, left
    iterations, cost, poses, points and inlier mask."""
    import test_torch_capacity as cap

    pj, pt = cap._window_problems(0)
    lm = (cap.jba.ChunkedLM(pj, "pinhole", 5, 10, chunk, window_layout=True)
          if package == "reference" else
          cap.tba.ChunkedLM(pt, "pinhole", 5, 10, chunk, window_layout=True))
    out = []
    while not lm.done:
        step = lm.step()
        out.append(dict(step=step, phase=lm.phase, left=lm.left,
                        cost=float(lm.cost), R=np.asarray(lm.poses.R),
                        t=np.asarray(lm.poses.t), points=np.asarray(lm.points),
                        inlier=np.asarray(lm.inlier)))
    return out


def _largest(a: list, b: list, key: str) -> float:
    return max(float(np.abs(x[key] - y[key]).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("chunk", [3, 5])
def test_chunked_lm_port_inside_reference_spread(chunk):
    if not _avx512():
        pytest.skip("OpenBLAS's SkylakeX core needs AVX-512")
    target = "test_torch_regime:chunked_lm_run"
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        refs = {core: pool.submit(call_in_regime, target, "reference", chunk,
                                  env=dict(PINNED, OPENBLAS_CORETYPE=core))
                for core in ("Haswell", "SkylakeX")}
        port = pool.submit(call_in_regime, target, "port", chunk)
        refs = {k: v.result() for k, v in refs.items()}
        port = port.result()
    pinned_ref = refs[PINNED["OPENBLAS_CORETYPE"]]
    assert len(port) == -(-5 // chunk) + -(-10 // chunk)
    for ref in refs.values():
        assert len(ref) == len(port)
        for k, (a, b) in enumerate(zip(ref, port)):
            assert (a["step"], a["phase"], a["left"]) == (
                b["step"], b["phase"], b["left"]), k
            np.testing.assert_array_equal(a["inlier"], b["inlier"])
    for key in ("R", "t", "points"):
        spread = _largest(refs["Haswell"], refs["SkylakeX"], key)
        assert _largest(port, pinned_ref, key) <= spread, (key, spread)
