"""PyTorch port parity: the visual-inertial solvers.

* ``make_problem`` / ``build_landmark_groups``: the landmark tables
  (integer, exact) against the reference's on seeded factor sets with
  invalid rows, duplicate observations and a ``max_obs`` truncation.
* ``visual_inertial_ba`` on small seeded problems (8 keyframes of the
  port's ``make_vio_sequence``, their preintegrations, noisy monocular or
  stereo observations of ~90 points, perturbed poses and velocities), with
  and without ``use_backward``: poses, velocities and biases within 1e-4,
  points within 1e-3 (C2: a point seen from few poses is held by the LM
  damping alone), the same LM accept decisions wherever a candidate's
  cost differs from the best so far by more than 1e-5 relative (closer
  than that, after convergence, is float32 rounding of the cost's sum).
* ``inertial_init`` on the same keyframes, with and without the scale:
  scale, ``R_wg``, biases and velocities within 1e-4, the same accept
  decisions where they are decisive by 1e-4 relative (the init's cost
  weighs residuals by informations up to 1e6, so its float32 rounding
  near convergence is ~1e-5 relative).
* The solver calls of the stereo-inertial session at ``SlamConfig``'s
  default widths, captured from the JAX package by
  ``tests/make_torch_goldens.py`` (``torch_goldens/
  stereo_vio_solver_calls.npz``): the IMU-init keyframe's
  ``inertial_init`` and full VI-BA (16 keyframe rows, 8192 points), and
  the first VIBA1 keyframe's windowed VI-BA (12 rows), ``inertial_init``
  and full VI-BA (48 rows). The port's results are held to the
  reference's recorded ones at the tolerances above, except the points:
  those seen by >= 5 factors within 1e-3 m, every point's reprojection
  within 0.02 px (``_assert_session_points``); its landmark tables to the
  reference's ``build_landmark_groups``, exactly.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_vio_problems as vp
from torch_regime import pinned
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.imu import preintegration as jp
from orb_slam_fusion_tpu.imu.factors import information_from_cov as j_info
from orb_slam_fusion_tpu.solver import ba as jba
from orb_slam_fusion_tpu.solver import vi_ba as jvi
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.imu import preintegration as tp
from orb_slam_fusion_tpu_torch.imu.factors import information_from_cov as t_info
from orb_slam_fusion_tpu_torch.solver import ba as tba
from orb_slam_fusion_tpu_torch.solver import vi_ba as tvi

# every test file sets the process-wide thread count when it is imported
# (the workers import all of them before running any)
torch.set_num_threads(1)
CAM, BF = vp.CAM, vp.BF
SNAPSHOT = (pathlib.Path(__file__).resolve().parent / "torch_goldens"
            / "stereo_vio_solver_calls.npz")


def _assert_same_decisions(want, got, rel=1e-5):
    """The LM accept decisions (each candidate cost against the best so
    far) agree wherever one is decisive: a decision within ``rel`` of the
    cost is float32 rounding of a sum of thousands of terms, which the two
    packages order differently once the solve has converged."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    bw, bg, n_ok = want[0], got[0], 0
    for k in range(1, len(want)):
        ow, og = bool(want[k] < bw), bool(got[k] < bg)
        if ow != og:
            assert (abs(want[k] - bw) <= rel * abs(bw)
                    or abs(got[k] - bg) <= rel * abs(bg)), (k, want, got)
        n_ok += ow
        bw = want[k] if ow else bw
        bg = got[k] if og else bg
    return n_ok


# ---------------------------------------------------------------------------
# make_problem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,max_obs", [(0, None), (1, 4), (2, 12)])
def test_landmark_groups_exact(seed, max_obs):
    rng = np.random.RandomState(seed)
    M, F = 50, 400
    mp_idx = rng.randint(0, M, F).astype(np.int32)
    dup = np.arange(0, F - 1, 7)
    mp_idx[dup] = mp_idx[dup + 1]                     # duplicates
    valid = rng.rand(F) > 0.2
    kf_idx = rng.randint(0, 8, F).astype(np.int32)
    pts = rng.randn(M, 3).astype(np.float32)
    uv = rng.rand(F, 2).astype(np.float32)
    jprob = jba.make_problem(
        jlie.SE3(jnp.eye(3)[None].repeat(8, 0), jnp.zeros((8, 3))),
        jnp.asarray(pts), kf_idx, mp_idx, jnp.asarray(uv), jnp.ones(F),
        valid, np.zeros(8, bool), jnp.asarray(CAM), max_obs=max_obs)
    tprob = tba.make_problem(
        tlie.SE3(torch.eye(3).repeat(8, 1, 1), torch.zeros(8, 3)),
        torch.from_numpy(pts), torch.from_numpy(kf_idx),
        torch.from_numpy(mp_idx), torch.from_numpy(uv), torch.ones(F),
        torch.from_numpy(valid), torch.zeros(8, dtype=torch.bool),
        torch.tensor(CAM), max_obs=max_obs)
    for f in ("lm_factor_idx", "lm_factor_valid", "kf_idx", "mp_idx",
              "valid", "fixed_point", "stereo_mask", "u_right"):
        np.testing.assert_array_equal(np.asarray(getattr(jprob, f)),
                                      getattr(tprob, f).numpy(), err_msg=f)
    assert float(tprob.bf) == float(jprob.bf)


# ---------------------------------------------------------------------------
# small seeded problems
# ---------------------------------------------------------------------------


def _ifacs(d):
    jc, tc = jp.make_calib(), tp.make_calib(device="cpu")
    z = np.zeros(3, np.float32)
    jb = jp.ImuBias(jnp.asarray(z), jnp.asarray(z))
    tb = tp.ImuBias(torch.from_numpy(z), torch.from_numpy(z))
    pj = [jp.preintegrate_host(*r, jb, jc) for r in d["raws"]]
    pt = [tp.preintegrate_host(*r, tb, tc) for r in d["raws"]]
    P = len(pj)
    import jax
    pre_j = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *pj)
    pre_t = tp.stack_preintegrated(pt)
    ii = np.arange(P, dtype=np.int32)
    jf = jvi.InertialFactorBatch(
        i=jnp.asarray(ii), j=jnp.asarray(ii + 1), pre=pre_j,
        info=jax.vmap(j_info)(pre_j), valid=jnp.ones(P, bool))
    tf = tvi.InertialFactorBatch(
        i=torch.from_numpy(ii), j=torch.from_numpy(ii + 1), pre=pre_t,
        info=t_info(pre_t), valid=torch.ones(P, dtype=torch.bool))
    return jf, tf, jc, tc


def _problems(d, stereo):
    K = d["R"].shape[0]
    st_j, st_t = {}, {}
    if stereo:
        st_j = dict(u_right=jnp.asarray(d["ur"]),
                    stereo_mask=jnp.asarray(d["smask"]), bf=BF)
        st_t = dict(u_right=torch.from_numpy(d["ur"]),
                    stereo_mask=torch.from_numpy(d["smask"]), bf=BF)
    jprob = jba.make_problem(
        jlie.SE3(jnp.asarray(d["R"]), jnp.asarray(d["t"])),
        jnp.asarray(d["pts"]), d["kf_idx"], d["mp_idx"], jnp.asarray(d["uv"]),
        jnp.asarray(d["inv_s2"]), d["valid"], d["fixed"], jnp.asarray(CAM),
        max_obs=K, **st_j)
    tprob = tba.make_problem(
        tlie.SE3(torch.from_numpy(d["R"]), torch.from_numpy(d["t"])),
        torch.from_numpy(d["pts"]), torch.from_numpy(d["kf_idx"]),
        torch.from_numpy(d["mp_idx"]), torch.from_numpy(d["uv"]),
        torch.from_numpy(d["inv_s2"]), torch.from_numpy(d["valid"]),
        torch.from_numpy(d["fixed"]), torch.tensor(CAM), max_obs=K, **st_t)
    return jprob, tprob


def _states(d):
    K = d["R"].shape[0]
    z = np.zeros((K, 3), np.float32)
    js = jvi.VIState(jlie.SE3(jnp.asarray(d["R"]), jnp.asarray(d["t"])),
                     jnp.asarray(d["vel"]), jnp.asarray(z), jnp.asarray(z))
    ts = tvi.VIState(tlie.SE3(torch.from_numpy(d["R"]),
                              torch.from_numpy(d["t"])),
                     torch.from_numpy(d["vel"]), torch.from_numpy(z),
                     torch.from_numpy(z))
    return js, ts


def _assert_state(js, ts, points_j=None, points_t=None, atol=1e-4):
    np.testing.assert_allclose(ts.poses.R.numpy(), np.asarray(js.poses.R),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(ts.poses.t.numpy(), np.asarray(js.poses.t),
                               atol=atol, rtol=0)
    for f in ("vel", "bg", "ba"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=atol,
                                   rtol=0, err_msg=f)
    if points_j is not None:
        np.testing.assert_allclose(points_t.numpy(), np.asarray(points_j),
                                   atol=1e-3, rtol=0)


@pinned
@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "use_backward"])
def test_visual_inertial_ba_seeded(stereo, backward):
    d = vp.seeded(3 if stereo else 4, stereo)
    jf, tf, jc, tc = _ifacs(d)
    jprob, tprob = _problems(d, stereo)
    js, ts = _states(d)
    fixed = d["fixed"]
    fin = fixed.copy()
    rj = jvi.visual_inertial_ba(js, jprob, jf, jc,
                                fixed_pose=jnp.asarray(fixed),
                                fixed_inertial=jnp.asarray(fin), iters=10,
                                use_backward=backward)
    rt = tvi.visual_inertial_ba(ts, tprob, tf, tc,
                                fixed_pose=torch.from_numpy(fixed),
                                fixed_inertial=torch.from_numpy(fin),
                                iters=10, use_backward=backward)
    costs_j = np.asarray(rj[2])
    assert _assert_same_decisions(costs_j, rt[2].numpy()) >= 3
    np.testing.assert_allclose(rt[2].numpy(), costs_j, rtol=1e-3)
    _assert_state(rj[0], rt[0], rj[1], rt[1])


@pytest.mark.parametrize("scale", [True, False], ids=["scale", "metric"])
def test_inertial_init_seeded(scale):
    d = vp.seeded(5, False, K=10, step=5, pose_noise=0.0)
    jf, tf, jc, tc = _ifacs(d)
    # scaled visual poses for the monocular case
    s = 0.6 if scale else 1.0
    jposes = jlie.SE3(jnp.asarray(d["R"]), jnp.asarray(d["t"] * s))
    tposes = tlie.SE3(torch.from_numpy(d["R"]),
                      torch.from_numpy(d["t"] * s))
    kw = dict(optimize_scale=scale, prior_g=1e2,
              prior_a=1e10 if scale else 1e5)
    oj = jvi.inertial_init(jposes, jf, jc, **kw)
    ot = tvi.inertial_init(tposes, tf, tc, **kw)
    _assert_init(oj, ot)


def _assert_init(oj, ot, atol=1e-4):
    sj, Rj, bj, vj, cj = oj
    st, Rt, bt, vt, ct = ot
    np.testing.assert_allclose(float(st), float(sj), rtol=atol)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=atol)
    np.testing.assert_allclose(bt.gyro.numpy(), np.asarray(bj.gyro),
                               atol=atol)
    np.testing.assert_allclose(bt.acc.numpy(), np.asarray(bj.acc), atol=atol)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=atol)
    # the init cost weighs residuals by informations up to 1e6: its float32
    # rounding near convergence is ~1e-5 relative
    _assert_same_decisions(cj, ct.numpy(), rel=1e-4)


# ---------------------------------------------------------------------------
# the stereo-inertial session's solver calls
# ---------------------------------------------------------------------------


def _load_snapshot():
    if not SNAPSHOT.exists():
        pytest.fail(f"{SNAPSHOT.name} missing: run tests/make_torch_goldens.py")
    z = np.load(SNAPSHOT)
    return {k: z[k] for k in z.files}


def _tree(z, prefix):
    return {k[len(prefix) + 1:]: v for k, v in z.items()
            if k.startswith(prefix + ".")}


def _t(a):
    return torch.from_numpy(np.array(a))


def _calib_t(z, key):
    c = _tree(z, key + ".calib")
    return tp.ImuCalib(*(_t(c[f]) for f in tp.ImuCalib._fields))


def _pre_t(c, prefix):
    f = {n: _t(c[f"{prefix}.{n}"]) for n in tp.Preintegrated._fields
         if n != "bias0"}
    return tp.Preintegrated(bias0=tp.ImuBias(_t(c[f"{prefix}.bias0.gyro"]),
                                             _t(c[f"{prefix}.bias0.acc"])),
                            **f)


def _ifac_t(z, key):
    c = _tree(z, key + ".ifac")
    return tvi.InertialFactorBatch(
        i=_t(c["i"]), j=_t(c["j"]), pre=_pre_t(c, "pre"), info=_t(c["info"]),
        valid=_t(c["valid"]))


def _calls(z, tag):
    keys = sorted({".".join(k.split(".")[:3]) for k in z
                   if k.startswith(tag + ".") and k.count(".") >= 3})
    return sorted(keys, key=lambda k: int(k.split(".")[1]))


def _run_vi_ba_call(z, key):
    s = _tree(z, key + ".state")
    state = tvi.VIState(tlie.SE3(_t(s["poses.R"]), _t(s["poses.t"])),
                        _t(s["vel"]), _t(s["bg"]), _t(s["ba"]))
    p = _tree(z, key + ".prob")
    W = state.poses.t.shape[0]
    prob = tba.make_problem(
        tlie.SE3(_t(p["poses.R"]), _t(p["poses.t"])), _t(p["points"]),
        _t(p["kf_idx"]), _t(p["mp_idx"]), _t(p["uv"]), _t(p["inv_sigma2"]),
        _t(p["valid"]), _t(p["fixed_pose"]), _t(p["cam_params"]),
        fixed_point=_t(p["fixed_point"]), max_obs=W, u_right=_t(p["u_right"]),
        stereo_mask=_t(p["stereo_mask"]), bf=float(p["bf"]))
    # the landmark tables: exactly the reference's
    lm_idx, lm_valid = jba.build_landmark_groups(
        p["mp_idx"], p["points"].shape[0], W, p["valid"])
    np.testing.assert_array_equal(prob.lm_factor_idx.numpy(), lm_idx)
    np.testing.assert_array_equal(prob.lm_factor_valid.numpy(), lm_valid)
    out = tvi.visual_inertial_ba(
        state, prob, _ifac_t(z, key), _calib_t(z, key),
        fixed_pose=_t(z[key + ".kw.fixed_pose"]),
        fixed_inertial=_t(z[key + ".kw.fixed_inertial"]),
        iters=int(z[key + ".kw.iters"]))
    o = _tree(z, key + ".out")
    want = tvi.VIState(tlie.SE3(o["0.poses.R"], o["0.poses.t"]), o["0.vel"],
                       o["0.bg"], o["0.ba"])
    _assert_same_decisions(o["2"], out[2].numpy())
    _assert_state(want, out[0])
    _assert_session_points(p, o, out)
    return W


def _assert_session_points(p, o, out):
    """A session point's position along its depth is barely constrained
    (one pixel of stereo disparity at 9 m and bf 50 px is 1.6 m of depth):
    the last damped LM steps set it, and the two packages take different
    ones once the cost is flat. So points seen by >= 5 factors are held to
    1e-3 m, and every point's reprojection into the window's keyframes to
    0.02 px of the reference's."""
    kf, mp, v = p["kf_idx"], p["mp_idx"], p["valid"]
    nobs = np.bincount(mp[v], minlength=o["1"].shape[0])
    well = nobs >= 5
    np.testing.assert_allclose(out[1].numpy()[well], o["1"][well],
                               atol=1e-3, rtol=0)
    cam = p["cam_params"].astype(np.float64)

    def proj(R, t, X):
        pc = (np.einsum("fij,fj->fi", R[kf].astype(np.float64),
                        X[mp].astype(np.float64)) + t[kf])
        return np.stack([cam[0] * pc[:, 0] / pc[:, 2] + cam[2],
                         cam[1] * pc[:, 1] / pc[:, 2] + cam[3]], 1)[v]

    want = proj(o["0.poses.R"], o["0.poses.t"], o["1"])
    got = proj(out[0].poses.R.numpy(), out[0].poses.t.numpy(),
               out[1].numpy())
    assert np.abs(got - want).max() < 0.02


def _run_init_call(z, key):
    p = _tree(z, key + ".poses")
    out = tvi.inertial_init(
        tlie.SE3(_t(p["R"]), _t(p["t"])), _ifac_t(z, key),
        _calib_t(z, key),
        optimize_scale=bool(z[key + ".kw.optimize_scale"]),
        prior_g=float(z[key + ".kw.prior_g"]),
        prior_a=float(z[key + ".kw.prior_a"]))
    o = _tree(z, key + ".out")
    want = (o["0"], o["1"], jp.ImuBias(o["2.gyro"], o["2.acc"]), o["3"],
            o["4"])
    _assert_init(want, out)


@pytest.mark.parametrize("tag", ["stage1", "stage2"],
                         ids=["imu_init_keyframe", "viba1_keyframe"])
def test_session_solver_calls(tag):
    z = _load_snapshot()
    calls = _calls(z, tag)
    names = [k.split(".")[2] for k in calls]
    if tag == "stage1":
        assert names == ["inertial_init", "visual_inertial_ba"], names
    else:
        assert names == ["visual_inertial_ba", "inertial_init",
                         "visual_inertial_ba"], names
    widths = []
    for key in calls:
        if key.endswith("inertial_init"):
            _run_init_call(z, key)
        else:
            widths.append(_run_vi_ba_call(z, key))
    # the full VI-BA pads the history to a multiple of 16 rows; the
    # windowed one is ba_window + ba_fixed_ring = 12 rows
    assert widths[-1] % 16 == 0 and widths[-1] >= 16
    if tag == "stage2":
        assert widths[0] == 12
