"""PyTorch port parity: the order of the PCG step's float32 sums (ROADMAP
C14b).

The problem and the reference's run are those of
``test_torch_ba_cg.py::test_lm_chunk_general_layout[pcg]``: 16 keyframes
x 96 factors, 256 landmarks, five LM iterations of ``lm_chunk`` with
``pose_stride`` 96. ``torch_pcg_reference.lm_chunk_opened`` (a copy of
the reference's program that returns its intermediates, held first to
``jba.lm_chunk``'s own carry and candidate costs bit for bit) gives, per
LM iteration, the state the step started from and what the step computed
from it. From those inputs, bit for bit:

* the factors ``r``, ``Jp``, ``Jl`` from the reference's poses and points
  (``ba._pcg_factors``);
* the landmark system ``Hll``, ``gl``, ``Hll_inv`` from the reference's
  factors (``ba._pcg_weights``, ``ba._pcg_landmark_system``), and the
  landmark step from the reference's pose step (``ba.
  _pcg_back_substitute``);
* the pose system ``Hpp`` and the reduced gradient ``g_r`` from the
  reference's factors and landmark system (``ba._pcg_pose_system``);
* the whole step with ``cg_iters=0`` (the landmark step alone) from the
  reference's state, against the reference's own ``_lm_step_cg`` jitted
  with ``cg_iters=0``.

The primitives at the shapes they serve, against XLA:CPU's own programs:
``rsqrt_f32`` (XLA's ``rsqrt``: the host's estimate and a Newton step;
the Huber weight), ``window_sum_f32`` (the pose segments' tree reduction
at the test's 96 factors a keyframe, ``chip_smoke.py``'s 48, and the
sessions' 1,200 and 5,000) and ``_inv3x3_fused`` (256 landmarks).
``chip_smoke.py`` holds the card to the golden
``torch_goldens/pcg_linearization.npz``; the last test holds that golden
to the reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ba_cg as B
import torch_fixtures as fx
import torch_pcg_reference as jref
import torch_pcg_replay as replay
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.solver import ba as jba
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.solver import ba as tba
from orb_slam_fusion_tpu_torch.utils.fused import rsqrt_f32, window_sum_f32

torch.set_num_threads(1)
ITERS = 5
STATIC = ("pinhole", ITERS, 5.991, True, B.NF)


def _assert_bits(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} differ, largest "
        f"{np.abs(got.astype(np.float64) - want).max():.3g}")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def run():
    """The test's problem in both packages, the reference's lm_chunk, and
    the opened copy's per-iteration intermediates (numpy)."""
    pj, pt, _ = replay._problems()
    inl = jnp.ones_like(pj.valid)
    c0 = jba.lm_cost(pj.poses, pj.points, inl, pj, "pinhole")
    args = (pj.poses, pj.points, jnp.float32(1e-4), c0, inl, pj)
    ref = jba.lm_chunk(*args, *STATIC)
    opened = jref.lm_chunk_opened(*args, *STATIC)
    seen = {k: np.asarray(v) for k, v in opened[4].items()}
    return pj, pt, ref, opened, seen


def _state(seen, it):
    return (tlie.SE3(_t(seen["R"][it]), _t(seen["t"][it])),
            _t(seen["X"][it]), _t(seen["lam"][it]))


def _active(pt, seen, it):
    poses, X, _ = _state(seen, it)
    depth_ok = tba._pcg_factors(poses, X, pt, "pinhole")[3]
    return pt.valid & depth_ok


def test_opened_copy_is_lm_chunk(run):
    _, _, ref, opened, seen = run
    for k, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(ref[:4]),
                                   jax.tree_util.tree_leaves(opened[:4]))):
        _assert_bits(b, a, f"carry leaf {k}")
    _assert_bits(seen["c1"], ref[4], "candidate costs")


@pytest.mark.parametrize("it", range(ITERS))
def test_pcg_factors_bit_exact(run, it):
    _, pt, _, _, seen = run
    poses, X, _ = _state(seen, it)
    r, Jp, Jl, _ = tba._pcg_factors(poses, X, pt, "pinhole")
    _assert_bits(r, seen["r"][it], "r")
    _assert_bits(Jp, seen["Jp"][it], "Jp")
    _assert_bits(Jl, seen["Jl"][it], "Jl")


@pytest.mark.parametrize("it", range(ITERS))
def test_pcg_landmark_system_bit_exact(run, it):
    _, pt, _, _, seen = run
    r, Jl = _t(seen["r"][it]), _t(seen["Jl"][it])
    w = tba._pcg_weights(r, _active(pt, seen, it), pt, 5.991, True)
    Hll, gl, Hll_inv = tba._pcg_landmark_system(r, Jl, w, pt,
                                                _t(seen["lam"][it]))
    _assert_bits(Hll, seen["Hll"][it], "Hll")
    _assert_bits(gl, seen["gl"][it], "gl")
    _assert_bits(Hll_inv, seen["Hll_inv"][it], "Hll_inv")
    # the landmark step from the reference's pose step and system
    _, _, Hpl_f = tba._pcg_pose_system(
        r, _t(seen["Jp"][it]), Jl, w, _t(seen["Hll_inv"][it]),
        _t(seen["gl"][it]), pt, B.NF)
    dx_l = tba._pcg_back_substitute(Hpl_f, _t(seen["dx_p"][it]),
                                    _t(seen["Hll_inv"][it]),
                                    _t(seen["gl"][it]), pt)
    _assert_bits(dx_l, seen["dx_l"][it], "dx_l")


@pytest.mark.parametrize("it", range(ITERS))
def test_pcg_pose_system_bit_exact(run, it):
    _, pt, _, _, seen = run
    r = _t(seen["r"][it])
    w = tba._pcg_weights(r, _active(pt, seen, it), pt, 5.991, True)
    Hpp, g_r, _ = tba._pcg_pose_system(
        r, _t(seen["Jp"][it]), _t(seen["Jl"][it]), w,
        _t(seen["Hll_inv"][it]), _t(seen["gl"][it]), pt, B.NF)
    _assert_bits(Hpp, seen["Hpp"][it], "Hpp")
    _assert_bits(g_r, seen["g_r"][it], "g_r")


@pytest.mark.parametrize("it", range(ITERS))
def test_pcg_landmark_step_cg0_bit_exact(run, it):
    pj, pt, _, _, seen = run
    step = jax.jit(functools.partial(
        jba._lm_step_cg, prob=pj, cam_model="pinhole", chi2_th=5.991,
        use_robust=True, pose_stride=B.NF, cg_iters=0))
    Pj = jlie.SE3(jnp.asarray(seen["R"][it]), jnp.asarray(seen["t"][it]))
    _, Xj, aj = step(Pj, jnp.asarray(seen["X"][it]),
                     jnp.asarray(seen["lam"][it]), jnp.ones_like(pj.valid))
    poses, X, lam = _state(seen, it)
    Pt, Xt, at = tba._lm_step_cg(poses, X, lam, torch.ones_like(pt.valid),
                                 pt, "pinhole", 5.991, True, B.NF,
                                 cg_iters=0)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    _assert_bits(Xt, Xj, "points after the cg_iters=0 step")
    _assert_bits(Pt.t, poses.t, "poses after the cg_iters=0 step")


@pytest.mark.parametrize("lo,hi", [(1e-12, 1.0), (1.0, 1e4), (1e4, 1e30)])
def test_rsqrt_f32_is_xlas_rsqrt(lo, hi):
    rng = np.random.RandomState(int(np.log10(hi)) + 40)
    x = np.exp(rng.uniform(np.log(lo), np.log(hi), 200_000)).astype(
        np.float32)
    x[:3] = (lo, hi, 4.0)
    want = jax.jit(jax.lax.rsqrt)(x)
    _assert_bits(rsqrt_f32(torch.from_numpy(x)), want, "rsqrt")
    # the Huber weight as the reference writes it, through that rsqrt
    huber = jax.jit(lambda c: jnp.minimum(
        jnp.sqrt(jnp.float32(5.991)) / jnp.sqrt(jnp.maximum(c, 1e-12)), 1.0))
    delta = torch.sqrt(torch.tensor(5.991, dtype=torch.float32).double())
    got = torch.clamp(delta.float() * rsqrt_f32(torch.clamp(
        torch.from_numpy(x), min=1e-12)), max=1.0)
    _assert_bits(got, huber(x), "Huber weight")


@pytest.mark.parametrize("n", [48, 96, 1200, 5000])
def test_window_sum_f32_is_xlas_tree_reduction(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(16 * n, 6) * np.exp(3 * rng.randn(16 * n, 6))).astype(
        np.float32)
    want = jax.jit(lambda x: x.reshape(16, n, 6).sum(axis=1))(x)
    _assert_bits(window_sum_f32(torch.from_numpy(x).reshape(16, n, 6), 1),
                 want, f"sum over {n}")


def test_inv3x3_fused_at_the_landmarks(run):
    _, _, _, _, seen = run
    H = seen["Hll"][0] + seen["Hll"][0] * np.eye(3, dtype=np.float32) \
        + np.float32(1e-8) * np.eye(3, dtype=np.float32)
    _assert_bits(tba._inv3x3_fused(torch.from_numpy(H)),
                 jax.jit(jba.inv3x3)(H), "inv3x3")


def test_pcg_golden_is_the_reference(run):
    """``torch_goldens/pcg_linearization.npz`` (the host port's sums, which
    ``chip_smoke.py`` holds the card to) is the reference's: its program's
    first iteration and its ``cg_iters=0`` step from each of the golden's
    states (which the CG's library calls decide, so they are inputs here);
    and the port on the host reproduces it."""
    pj, _, _, _, _ = run
    g = fx.load_pcg_golden()
    inl = jnp.ones_like(pj.valid)
    step0 = jax.jit(functools.partial(
        jba._lm_step_cg, prob=pj, cam_model="pinhole", chi2_th=5.991,
        use_robust=True, pose_stride=B.NF, cg_iters=0))
    for it in fx.PCG_GOLDEN_ITERS:
        P = jlie.SE3(jnp.asarray(g[f"R_{it}"]), jnp.asarray(g[f"t_{it}"]))
        X, lam = jnp.asarray(g[f"X_{it}"]), jnp.asarray(g[f"lam_{it}"])
        first = jref.lm_chunk_opened(
            P, X, lam, jba.lm_cost(P, X, inl, pj, "pinhole"), inl, pj,
            *STATIC)[4]
        for k in fx.PCG_GOLDEN_SUMS:
            _assert_bits(g[f"{k}_{it}"], first[k][0], f"{k}, {it}")
        _assert_bits(g[f"cg0_X_{it}"], step0(P, X, lam, inl)[1],
                     f"cg0_X, {it}")
    out = fx.pcg_port_sums(fx.pcg_problem(g, "cpu"), g, "cpu")
    assert sorted(out) == sorted(k for k in g.files if k[:-2] in
                                 fx.PCG_GOLDEN_SUMS + ("cg0_X",))
    for key, v in out.items():
        _assert_bits(v, g[key], key)
