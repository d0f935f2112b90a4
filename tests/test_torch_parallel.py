"""PyTorch port parity: the multi-device paths (``parallel/``).

Counterparts of ``tests/test_parallel.py``'s mesh cases. The reference's
own problem builders (``test_parallel._synthetic_problem``,
``TestDistributedTracking._frame``, the drifted loop) make the inputs; they
go to the JAX package's solvers on its 8 virtual CPU devices
(``tests/conftest.py``) and, as the same numpy arrays, to the port's on a
mesh of 8 CPU shards (``make_slam_mesh(devices=[cpu] * 8)``).

Tolerances: poses within 1e-4 (rotation entries and metres), points
within 1e-3 m, costs within 1e-3 relative or 1e-6 of the largest cost
absolute (a converged cost is float32 rounding of a sum; the two packages
sum the Schur partials in different orders, so the solves agree up to
float32 reduction order); match indices, inlier flags, counters and
counts bit for bit. Each solver is also held against the port's
single-device solver at D = 1, 3 and 8 shards, within the same
tolerances, and two runs must agree to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_parallel as ref
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.parallel import (
    distributed_bundle_adjustment as j_dba,
    distributed_frame_update as j_dtrack,
    distributed_pose_graph as j_dpg, make_slam_mesh as j_mesh,
    pad_map_for_mesh as j_pad)
from orb_slam_fusion_tpu.solver.pose_graph import (
    PoseGraphProblem as JPGP)
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.engine import step as tstep
from orb_slam_fusion_tpu_torch.frontend import masked_match as tmm
from orb_slam_fusion_tpu_torch.map.convert import desc_to_torch
from orb_slam_fusion_tpu_torch.parallel import (
    SlamMesh, distributed_bundle_adjustment, distributed_frame_update,
    distributed_pose_graph, make_slam_mesh, pad_map_for_mesh)
from orb_slam_fusion_tpu_torch.solver import ba as tba
from orb_slam_fusion_tpu_torch.utils import fused
from orb_slam_fusion_tpu_torch.solver.pose_graph import (
    PoseGraphProblem as TPGP, optimize_pose_graph)

torch.set_num_threads(1)
CPU = torch.device("cpu")
POSE_ATOL = 1e-4
POINT_ATOL = 1e-3
COST_RTOL = 1e-3


def cpu_mesh(n):
    return make_slam_mesh(devices=[CPU] * n)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def port_problem(jp):
    """The port's BAProblem from the reference's (the same arrays)."""
    return tba.BAProblem(
        poses=tlie.SE3(_t(jp.poses.R), _t(jp.poses.t)), points=_t(jp.points),
        kf_idx=_t(jp.kf_idx), mp_idx=_t(jp.mp_idx), uv=_t(jp.uv),
        inv_sigma2=_t(jp.inv_sigma2), valid=_t(jp.valid),
        fixed_pose=_t(jp.fixed_pose), fixed_point=_t(jp.fixed_point),
        cam_params=_t(jp.cam_params), lm_factor_idx=_t(jp.lm_factor_idx),
        lm_factor_valid=_t(jp.lm_factor_valid), u_right=_t(jp.u_right),
        stereo_mask=_t(jp.stereo_mask),
        bf=torch.tensor(float(jp.bf), dtype=torch.float32))


def assert_close_run(j, t, costs=True):
    """(poses, points, costs) of the reference against the port's."""
    np.testing.assert_allclose(t[0].R.numpy(), _np(j[0].R), atol=POSE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(t[0].t.numpy(), _np(j[0].t), atol=POSE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(t[1].numpy(), _np(j[1]), atol=POINT_ATOL,
                               rtol=0)
    if costs:
        assert_costs(t[2], j[2])


def assert_costs(got, want, floor=1e-6):
    """Within COST_RTOL, or ``floor`` of the largest cost absolute."""
    want = _np(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=COST_RTOL,
                               atol=floor * np.abs(want).max())


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_shards_pads_and_sums_in_rank_order():
    mesh = cpu_mesh(3)
    assert mesh.shape == {"mp": 3}
    x = torch.arange(10)
    parts = mesh.shard(x, fill=-1)
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                           [8, 9, -1, -1]]
    assert mesh.gather(parts)[:10].tolist() == x.tolist()
    # rank order: ((a + b) + c), whatever float32 makes of it
    a, b, c = (torch.tensor([v], dtype=torch.float32)
               for v in (1e8, -1e8, 1.0))
    assert mesh.psum([a, b, c]).item() == 1.0
    assert mesh.psum([c, a, b]).item() == 0.0
    H, g = mesh.psum([(torch.ones(2), torch.ones(1))] * 3)
    assert H.tolist() == [3.0, 3.0] and g.tolist() == [3.0]


# ---------------------------------------------------------------------------
# distributed BA (test_parallel.TestDistributedBA)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pts,iters,seed", [(96, 12, 0), (50, 8, 1)],
                         ids=["divisible", "pads_to_56"])
def test_distributed_ba_matches_reference(n_pts, iters, seed):
    """The reference's two BA cases on 8 shards: the same poses, points and
    costs as the JAX package's mesh run; its gates (descent, pose error
    against the truth); the 50-point case pads to 56 with inert rows."""
    jp, poses_true, _ = ref._synthetic_problem(jax.random.PRNGKey(seed),
                                               n_pts=n_pts)
    j = j_dba(jp, j_mesh(8), iters=iters)
    t = distributed_bundle_adjustment(port_problem(jp), cpu_mesh(8),
                                      iters=iters)
    assert_close_run(j, t)
    assert t[1].shape == (n_pts, 3)
    costs = t[2].numpy()
    assert np.isfinite(costs).all()
    if n_pts == 96:
        assert costs[-1] < costs[0] * 1e-2, costs
        rel = tlie.se3_compose(t[0], tlie.se3_inverse(
            tlie.SE3(_t(poses_true.R), _t(poses_true.t))))
        assert tlie.se3_log(rel).abs().max().item() < 5e-3
    else:
        assert costs[-1] < costs[0] * 0.1


@pytest.mark.parametrize("D", [1, 3, 8])
def test_distributed_ba_matches_single_device(D):
    """Two-phase dist BA (5 robust + 10 plain iterations) against the
    port's single-device ``bundle_adjustment`` on the same general-layout
    problem, at 1, 3 and 8 shards; a second run repeats to the bit."""
    jp, _, _ = ref._synthetic_problem(jax.random.PRNGKey(2), n_pts=61)
    prob = port_problem(jp)
    sp, spts, _, scosts = tba.bundle_adjustment(prob, iters_first=5,
                                                iters_second=10)
    mesh = cpu_mesh(D)
    d1 = distributed_bundle_adjustment(prob, mesh, iters=5, iters_second=10)
    np.testing.assert_allclose(d1[0].R.numpy(), sp.R.numpy(),
                               atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(d1[0].t.numpy(), sp.t.numpy(),
                               atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(d1[1].numpy(), spts.numpy(), atol=POINT_ATOL,
                               rtol=0)
    assert_costs(d1[2], scosts.numpy())
    d2 = distributed_bundle_adjustment(prob, mesh, iters=5, iters_second=10)
    for a, b in zip((d1[0].R, d1[0].t, d1[1], d1[2]),
                    (d2[0].R, d2[0].t, d2[1], d2[2])):
        assert torch.equal(a, b)


def test_distributed_ba_two_phase_matches_reference():
    """``iters_second`` > 0 (the loop closer's 3 + 7): the chi2 re-mask
    between the phases, against the reference's mesh run."""
    jp, _, _ = ref._synthetic_problem(jax.random.PRNGKey(3), n_pts=75)
    j = j_dba(jp, j_mesh(8), iters=3, iters_second=7)
    t = distributed_bundle_adjustment(port_problem(jp), cpu_mesh(8),
                                      iters=3, iters_second=7)
    assert_close_run(j, t)


# ---------------------------------------------------------------------------
# distributed pose graph (test_parallel.TestDistributedPoseGraph)
# ---------------------------------------------------------------------------


def _drifted_loop():
    """test_parallel's 12-node drifted loop, as numpy."""
    K = 12
    gt = []
    for k in range(K):
        ang = 2 * np.pi * k / K
        R = _np(jlie.so3_exp(jnp.array([0.0, ang, 0.0])))
        t = np.array([np.sin(ang) * 3, 0.0, 3 - np.cos(ang) * 3])
        gt.append(jlie.Sim3(jnp.asarray(1.0), jnp.asarray(R, jnp.float32),
                            jnp.asarray(t, jnp.float32)))
    ei, ej, rels = [], [], []
    for k in range(K - 1):
        rels.append(jlie.sim3_compose(gt[k + 1], jlie.sim3_inverse(gt[k])))
        ei.append(k)
        ej.append(k + 1)
    rels.append(jlie.sim3_compose(gt[0], jlie.sim3_inverse(gt[K - 1])))
    ei.append(K - 1)
    ej.append(0)
    rng = np.random.RandomState(3)
    drift = []
    for k in range(K):
        xi = np.zeros(7, np.float32)
        xi[:3] = rng.randn(3) * 0.05 * (k / K)
        xi[6] = 0.1 * (k / K)
        drift.append(jlie.sim3_compose(jlie.sim3_exp(jnp.asarray(xi)),
                                       gt[k]))

    def stack(xs):
        return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *xs)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(poses=stack(drift), rel=stack(rels),
                ei=np.asarray(ei, np.int32), ej=np.asarray(ej, np.int32),
                fixed=fixed)


def _pg_problems(d):
    E = len(d["ei"])
    jprob = JPGP(poses=d["poses"], edge_i=jnp.asarray(d["ei"]),
                 edge_j=jnp.asarray(d["ej"]), edge_rel=d["rel"],
                 edge_weight=jnp.ones(E, jnp.float32),
                 edge_valid=jnp.ones(E, bool), fixed=jnp.asarray(d["fixed"]))
    tprob = TPGP(poses=tlie.Sim3(*(_t(x) for x in d["poses"])),
                 edge_i=_t(d["ei"]), edge_j=_t(d["ej"]),
                 edge_rel=tlie.Sim3(*(_t(x) for x in d["rel"])),
                 edge_weight=torch.ones(E), edge_valid=torch.ones(
                     E, dtype=torch.bool), fixed=_t(d["fixed"]))
    return jprob, tprob


def _assert_sim3(j, t, atol):
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), _np(a), atol=atol, rtol=0)


@pytest.mark.parametrize("four_dof,iters", [(False, 25), (True, 10)],
                         ids=["sim3", "4dof"])
def test_distributed_pose_graph_matches_reference(four_dof, iters):
    """The drifted 12-node loop (12 edges pad to 16 over 8 shards), the
    reference test's 25 iterations (10 in the 4-DoF mode), against the
    reference's mesh run and the port's single-device optimizer: poses
    within 1e-4, costs within 1e-3 relative or 1e-9 absolute (the
    converged cost is ~0), and the reference test's gates."""
    jprob, tprob = _pg_problems(_drifted_loop())
    jposes, jcosts = j_dpg(jprob, j_mesh(8), iters=iters, four_dof=four_dof)
    sposes, _ = optimize_pose_graph(tprob, iters=iters, four_dof=four_dof)
    dposes, dcosts = distributed_pose_graph(tprob, cpu_mesh(8), iters=iters,
                                            four_dof=four_dof)
    _assert_sim3(jposes, dposes, POSE_ATOL)
    _assert_sim3(sposes, dposes, POSE_ATOL)
    np.testing.assert_allclose(dcosts.numpy(), _np(jcosts), rtol=1e-3,
                               atol=1e-9)
    if not four_dof:
        assert dcosts[-1].item() < 1e-6
        assert (dposes.t - sposes.t).abs().max().item() < 1e-3


@pytest.mark.parametrize("D", [1, 3])
def test_distributed_pose_graph_matches_single_device(D):
    """The same loop at 1 and 3 shards (8 above), 8 iterations, against
    the port's single-device optimizer: poses within 1e-4, costs within
    1e-3 relative or 1e-9 absolute."""
    _, tprob = _pg_problems(_drifted_loop())
    sposes, scosts = optimize_pose_graph(tprob, iters=8)
    dposes, dcosts = distributed_pose_graph(tprob, cpu_mesh(D), iters=8)
    _assert_sim3(sposes, dposes, POSE_ATOL)
    np.testing.assert_allclose(dcosts.numpy(), scosts.numpy(), rtol=1e-3,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# distributed tracking (test_parallel.TestDistributedTracking)
# ---------------------------------------------------------------------------


def _track_inputs(M=256, F=128, bits=0, seed=None):
    """The reference's frame (its seeded keys), as numpy; ``bits`` flips
    that many descriptor bits per keypoint so the ratio test has work."""
    pts, desc, true_pose, kp_uv, kp_desc, kp_valid = \
        ref.TestDistributedTracking()._frame(M, F)
    kp_desc = _np(kp_desc).copy()
    if bits:
        rng = np.random.RandomState(seed)
        for _ in range(bits):
            w = rng.randint(0, 8, F)
            kp_desc[np.arange(F), w] ^= (
                np.uint32(1) << rng.randint(0, 32, F).astype(np.uint32))
    return (_np(pts), _np(desc), true_pose, _np(kp_uv), kp_desc,
            _np(kp_valid))


def _run_track_pair(M, F, iters, bits=0, seed=None, D=8):
    pts, desc, true_pose, kp_uv, kp_desc, kp_valid = _track_inputs(
        M, F, bits, seed)
    mesh = j_mesh(8)
    mp = j_pad(mesh, jnp.asarray(pts), jnp.asarray(desc), jnp.ones(M, bool),
               jnp.zeros(M, jnp.int32), jnp.zeros(M, jnp.int32))
    j = j_dtrack(*mp, jlie.se3_identity(), jlie.se3_identity(),
                 jnp.asarray(kp_uv), jnp.asarray(kp_desc),
                 jnp.asarray(kp_valid), jnp.ones(F), ref.CAM, mesh,
                 iters=iters)
    tmesh = cpu_mesh(D)
    tm = pad_map_for_mesh(tmesh, _t(pts), desc_to_torch(desc, CPU),
                          torch.ones(M, dtype=torch.bool),
                          torch.zeros(M, dtype=torch.int32),
                          torch.zeros(M, dtype=torch.int32))
    ident = tlie.se3_identity(device=CPU)
    t = distributed_frame_update(
        *tm, ident, ident, _t(kp_uv), desc_to_torch(kp_desc, CPU),
        _t(kp_valid), torch.ones(F), _t(_np(ref.CAM)), tmesh, iters=iters)
    return j, t, true_pose


def _assert_same_track(j, t, M):
    """Map rows [:M] (the padding differs with the shard count) and the
    counts bit for bit, the pose within 1e-4."""
    for f in ("match_idx", "inlier", "mp_visible", "mp_found"):
        np.testing.assert_array_equal(getattr(t, f)[:M].numpy(),
                                      _np(getattr(j, f))[:M], err_msg=f)
    np.testing.assert_array_equal(t.counts.numpy(), _np(j.counts))
    np.testing.assert_allclose(t.pose.R.numpy(), _np(j.pose.R),
                               atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(t.pose.t.numpy(), _np(j.pose.t),
                               atol=POSE_ATOL, rtol=0)


def test_distributed_tracking_recovers_pose_as_reference():
    """test_recovers_pose_on_mesh: 10 iterations; the reference's result
    (matches, inliers, counters, counts exact; pose 1e-4) and its gates."""
    j, t, true_pose = _run_track_pair(256, 128, iters=10)
    _assert_same_track(j, t, 256)
    err = tlie.se3_log(tlie.se3_compose(t.pose, tlie.se3_inverse(
        tlie.SE3(_t(true_pose.R), _t(true_pose.t)))))
    assert err.norm().item() < 1e-3
    n_match, n_in = t.counts.tolist()
    assert n_in > 128 // 2
    assert int(t.mp_found.sum()) == n_in


@pytest.mark.parametrize("M,F,bits,seed,D", [
    (256, 128, 0, None, 8), (200, 96, 6, 5, 8), (200, 96, 6, 5, 3),
    (251, 128, 4, 7, 1)], ids=["ref", "flips8", "flips3", "pad1"])
def test_distributed_tracking_matches_reference(M, F, bits, seed, D):
    """test_matches_single_device_step's frame and noisier variants (bit
    flips make the ratio test and the inlier toggle decide), against the
    reference's 8-device run at 1, 3 and 8 port shards: integer outputs
    bit for bit; and the pose within 1e-2 of the single-device fused step
    (the reference test's bound)."""
    j, t, _ = _run_track_pair(M, F, iters=6, bits=bits, seed=seed, D=D)
    _assert_same_track(j, t, M)
    if bits == 0:
        pts, desc, _, kp_uv, kp_desc, kp_valid = _track_inputs(M, F)
        ident = tlie.se3_identity(device=CPU)
        single = tstep.fused_track_step(
            _t(pts), desc_to_torch(desc, CPU), torch.ones(M, dtype=torch.bool),
            ident, ident, _t(kp_uv), desc_to_torch(kp_desc, CPU),
            _t(kp_valid), torch.zeros(F, dtype=torch.int32), torch.ones(F),
            _t(_np(ref.CAM)))
        rel = tlie.se3_log(tlie.se3_compose(t.pose,
                                            tlie.se3_inverse(single.pose)))
        assert rel.norm().item() < 1e-2


def test_fused_window_rounds_as_xla():
    """The distributed tracker's window ``sum((uv - kp)**2) <= r*r`` as
    XLA:CPU computes it (one rounding: fma(dv, dv, du*du)): the plain
    version's fused mode agrees with the jitted reference on pairs placed
    at the rounding boundary, where the separately rounded sum differs."""
    rng = np.random.RandomState(0)
    M, N = 512, 256
    uv = rng.uniform(0, 752, (M, 2)).astype(np.float32)
    kp = rng.uniform(0, 752, (N, 2)).astype(np.float32)
    r = np.float32(15.0)
    # put every keypoint's u on the window's edge for one row
    rows = rng.randint(0, M, N)
    dv = rng.uniform(-14, 14, N).astype(np.float32)
    kp[:, 1] = uv[rows, 1] + dv
    du = np.sqrt(np.maximum(r * r - (kp[:, 1] - uv[rows, 1]) ** 2,
                            0)).astype(np.float32)
    kp[:, 0] = uv[rows, 0] + du * np.sign(rng.randn(N)).astype(np.float32)

    @jax.jit
    def ref_mask(a, b):
        d2 = jnp.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
        return d2 <= r * r
    want = _np(ref_mask(jnp.asarray(uv), jnp.asarray(kp)))
    uvr, kp_uvo = tmm._fold(_t(uv), torch.ones(M, dtype=torch.bool),
                            float(r), _t(kp), torch.ones(N, dtype=torch.bool),
                            None, None)
    got = tmm.window_mask(uvr, kp_uvo, fused_window=True).numpy()
    plain = tmm.window_mask(uvr, kp_uvo).numpy()
    assert (plain != want).sum() > 0       # the case tells them apart
    np.testing.assert_array_equal(got, want)


def test_sq_add_rounds_once():
    """``sq_add_f32`` against an exact float64 fma on random and tie-prone
    operands (small integers, halfway sums)."""
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(4000) * 100, rng.randint(-4096, 4096, 2000)
                        + 0.5, rng.randn(2000) * 1e-3]).astype(np.float32)
    acc = np.concatenate([rng.randn(4000) * 1e4,
                          rng.randint(0, 2 ** 24, 2000) * 2.0,
                          rng.randn(2000)]).astype(np.float32)
    got = fused.sq_add_f32(_t(x), _t(acc)).numpy()
    from fractions import Fraction
    for i in range(0, len(x), 7):
        exact = Fraction(float(x[i])) ** 2 + Fraction(float(acc[i]))
        f = np.float32(float(exact))       # double rounding, checked below
        lo = np.nextafter(f, np.float32(-np.inf))
        hi = np.nextafter(f, np.float32(np.inf))
        best = min((lo, f, hi), key=lambda c: (abs(Fraction(float(c)) - exact),
                                               int(np.frombuffer(
                                                   c.tobytes(), np.uint32)[0])
                                               & 1))
        assert got[i] == best, (i, x[i], acc[i], got[i], best)


def test_make_slam_mesh_on_a_cpu_list():
    mesh = make_slam_mesh(devices=["cpu", "cpu"])
    assert isinstance(mesh, SlamMesh) and mesh.size == 2
    assert all(d.type == "cpu" for d in mesh.devices)
