"""PyTorch port parity: lie, cameras, robust kernels, map state, pattern.

Inputs come from numpy with a fixed seed; each test states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import cameras as jcam
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.frontend import orb_pattern as jpat
from orb_slam_fusion_tpu.map import map_state as jms
from orb_slam_fusion_tpu.solver import robust as jrob
from orb_slam_fusion_tpu_torch import cameras as tcam
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.frontend import orb_pattern as tpat
from orb_slam_fusion_tpu_torch.map import convert
from orb_slam_fusion_tpu_torch.map import map_state as tms
from orb_slam_fusion_tpu_torch.solver import robust as trob
from orb_slam_fusion_tpu_torch.utils import masked_set, masked_set_last

torch.set_num_threads(1)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, t, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=rtol,
                               atol=atol)


def _xi(rng, n, small=False):
    xi = rng.randn(n, 6).astype(np.float32)
    if small:
        xi[:8, 3:] *= 1e-6          # exercise the small-angle branches
    return xi


@pytest.mark.parametrize("small", [False, True])
def test_se3_exp_log_compose_apply(small):
    """rtol 1e-5 (atol 1e-6 around zero) against the reference."""
    rng = np.random.RandomState(0)
    xi = _xi(rng, 64, small)
    pts = rng.randn(64, 3).astype(np.float32)
    Tj = jlie.se3_exp(jnp.asarray(xi))
    Tt = tlie.se3_exp(_t(xi))
    _close(Tj.R, Tt.R)
    _close(Tj.t, Tt.t)
    _close(jlie.se3_log(Tj), tlie.se3_log(Tt), atol=1e-5)
    _close(jlie.se3_apply(Tj, jnp.asarray(pts)), tlie.se3_apply(Tt, _t(pts)))
    Ij, It = jlie.se3_inverse(Tj), tlie.se3_inverse(Tt)
    _close(Ij.t, It.t)
    Cj = jlie.se3_compose(Tj, Ij)
    Ct = tlie.se3_compose(Tt, It)
    _close(Cj.R, Ct.R)
    _close(Cj.t, Ct.t)
    Bj = jlie.se3_boxplus(Tj, jnp.asarray(xi[::-1].copy() * 0.1))
    Bt = tlie.se3_boxplus(Tt, _t(xi[::-1].copy() * 0.1))
    _close(Bj.R, Bt.R)
    _close(Bj.t, Bt.t)


def test_so3_and_hat():
    """rtol 1e-5 against the reference, incl. angles near 0 and near pi."""
    rng = np.random.RandomState(1)
    w = rng.randn(32, 3).astype(np.float32)
    w[0] = [np.pi - 1e-3, 0, 0]
    w[1] = [0, 0, 1e-7]
    _close(jlie.hat(jnp.asarray(w)), tlie.hat(_t(w)))
    Rj = jlie.so3_exp(jnp.asarray(w))
    Rt = tlie.so3_exp(_t(w))
    _close(Rj, Rt)
    _close(jlie.so3_log(Rj), tlie.so3_log(Rt), atol=1e-5)
    ident = tlie.se3_identity((4,), device="cpu")
    np.testing.assert_array_equal(ident.R.numpy(),
                                  np.asarray(jlie.se3_identity((4,)).R))


def test_so3_normalize():
    """rtol 1e-5 (atol 1e-6) against the reference on rotations bent off
    SO(3) by up to 1e-2, each pivot of the quaternion extraction reached
    (angles near 0 and near pi); the result lies on SO(3) to 1e-6."""
    rng = np.random.RandomState(2)
    w = rng.randn(32, 3).astype(np.float32)
    w[0] = [np.pi - 1e-3, 0, 0]
    w[1] = [0, np.pi - 1e-3, 0]
    w[2] = [0, 0, np.pi - 1e-3]
    w[3] = [0, 0, 1e-7]
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    E = rng.randn(32, 3, 3).astype(np.float32)
    bent = (R @ (np.eye(3, dtype=np.float32)
                 + 1e-2 * rng.rand(32, 1, 1).astype(np.float32) * E))
    Rt = tlie.so3_normalize(_t(bent))
    _close(jlie.so3_normalize(jnp.asarray(bent)), Rt)
    assert float(tlie.so3_orthonormality_error(Rt)) < 1e-6


def test_pinhole_and_triangulation():
    """project / project_jac / unproject rtol 1e-5; triangulated points
    rtol 1e-4: three float32 Gauss-Newton 3x3 solves on noisy rays
    amplify rounding along the depth direction."""
    rng = np.random.RandomState(2)
    cam = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    X = np.stack([rng.uniform(-2, 2, 128), rng.uniform(-2, 2, 128),
                  rng.uniform(2, 9, 128)], 1).astype(np.float32)
    _close(jcam.project(jcam.PINHOLE, jnp.asarray(cam), jnp.asarray(X)),
           tcam.project(tcam.PINHOLE, _t(cam), _t(X)), atol=1e-4)
    _close(jcam.project_jac(jcam.PINHOLE, jnp.asarray(cam), jnp.asarray(X)),
           tcam.project_jac(tcam.PINHOLE, _t(cam), _t(X)), atol=1e-4)
    uv = rng.uniform(0, 700, (128, 2)).astype(np.float32)
    _close(jcam.unproject(jcam.PINHOLE, jnp.asarray(cam), jnp.asarray(uv)),
           tcam.unproject(tcam.PINHOLE, _t(cam), _t(uv)))
    # two views 0.3 m apart with a small rotation
    R21 = np.asarray(jlie.so3_exp(jnp.asarray([0.01, 0.05, -0.02])),
                     np.float32)
    t21 = np.array([-0.3, 0.02, 0.01], np.float32)
    X2 = X @ R21.T + t21
    r1 = X / X[:, 2:3]
    r2 = X2 / X2[:, 2:3]
    r1[:, :2] += rng.randn(128, 2).astype(np.float32) * 1e-3
    args_j = [jnp.asarray(a) for a in (r1, r2, R21, t21)]
    args_t = [_t(a) for a in (r1, r2, R21, t21)]
    _close(jcam.triangulate_midpoint(*args_j),
           tcam.triangulate_midpoint(*args_t), rtol=1e-4, atol=1e-5)
    _close(jcam.triangulate(*args_j), tcam.triangulate(*args_t), rtol=1e-4,
           atol=1e-5)


def test_huber_kernels():
    """Huber weight and rho rtol 1e-5 on both sides of the threshold."""
    chi2 = np.concatenate([np.linspace(0, 20, 101), [0.0, 1e-14]]).astype(
        np.float32)
    for d2 in (trob.CHI2_2D, trob.CHI2_3D):
        _close(jrob.huber_weight(jnp.asarray(chi2), d2),
               trob.huber_weight(_t(chi2), d2))
        _close(jrob.huber_rho(jnp.asarray(chi2), d2),
               trob.huber_rho(_t(chi2), d2))
    assert (trob.CHI2_2D, trob.CHI2_3D) == (jrob.CHI2_2D, jrob.CHI2_3D)


def test_orb_pattern_copy_is_identical():
    """The port's own pattern table equals the reference's, bit for bit."""
    np.testing.assert_array_equal(tpat.PATTERN, jpat.PATTERN)
    assert tpat.PATCH_RADIUS == jpat.PATCH_RADIUS


def test_map_state_ops_match_reference():
    """make_empty_map / add_map_points / add_keyframe / scale band /
    predict_scale / observation_triples: integer fields exact, floats
    rtol 1e-5."""
    rng = np.random.RandomState(3)
    K, M, F, B = 6, 40, 16, 24
    pos = rng.uniform(-3, 3, (B, 3)).astype(np.float32) + [0, 0, 6]
    desc = rng.randint(0, 2 ** 32, (B, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.rand(B) > 0.3
    dist = np.linalg.norm(pos, axis=1).astype(np.float32)
    octv = rng.randint(0, 8, B).astype(np.int32)

    mj = jms.make_empty_map(K, M, F)
    mt = tms.make_empty_map(K, M, F, device="cpu")
    mnj, mxj = jms.scale_invariance_band(jnp.asarray(dist), jnp.asarray(octv),
                                         8)
    mnt, mxt = tms.scale_invariance_band(_t(dist), _t(octv), 8)
    _close(mnj, mnt)
    _close(mxj, mxt)
    for _ in range(2):                      # second batch overflows M
        mj, idj = jms.add_map_points(
            mj, jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(pos),
            jnp.int32(1), jnp.int32(2), jnp.asarray(valid), mnj, mxj)
        mt, idt = tms.add_map_points(
            mt, _t(pos), convert.desc_to_torch(desc, "cpu"), _t(pos),
            1, 2, _t(valid), mnt, mxt)
        np.testing.assert_array_equal(np.asarray(idj), idt.numpy())
    for k in range(K + 1):                  # last insert finds it full
        uv = rng.uniform(0, 600, (F, 2)).astype(np.float32)
        obs = rng.randint(-1, M, F).astype(np.int32)
        fv = rng.rand(F) > 0.2
        R = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3) * 0.1)),
                       np.float32)
        t = rng.randn(3).astype(np.float32)
        mj, kj = jms.add_keyframe(
            mj, jlie.SE3(jnp.asarray(R), jnp.asarray(t)), 0.1 * k,
            jnp.asarray(uv), jnp.asarray(desc[:F]),
            jnp.asarray(octv[:F]), jnp.asarray(fv), jnp.asarray(obs))
        mt, kt = tms.add_keyframe(
            mt, tlie.SE3(_t(R), _t(t)), 0.1 * k, _t(uv),
            convert.desc_to_torch(desc[:F], "cpu"), _t(octv[:F]), _t(fv),
            _t(obs))
        assert int(kj) == int(kt)
    fj = {k: np.asarray(v) for k, v in mj._asdict().items()
          if k != "kf_pose"}
    ft = convert.map_state_to_numpy(mt)
    for k, v in fj.items():
        np.testing.assert_allclose(v, ft[k], rtol=RTOL, err_msg=k)
    window = np.array([4, -1, 0, 2], np.int32)
    for a, b in zip(jms.observation_triples(mj, jnp.asarray(window)),
                    tms.observation_triples(mt, _t(window))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    d = rng.uniform(0.5, 20, M).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jms.predict_scale(jnp.asarray(d), mj.mp_max_dist, 8)),
        tms.predict_scale(_t(d), mt.mp_max_dist, 8).numpy())
    np.testing.assert_array_equal(
        np.asarray(jms.observation_mask(mj)),
        tms.observation_mask(mt).numpy())


def test_masked_set_drops_and_resolves_duplicates():
    """Masked rows and out-of-range rows are dropped; masked_set_last keeps
    the last writer of a row, as the reference's CPU scatter does."""
    table = torch.zeros(5, dtype=torch.int32)
    idx = torch.tensor([1, 3, 1, 9, 3, 0], dtype=torch.int32)
    vals = torch.tensor([10, 20, 30, 40, 50, 60], dtype=torch.int32)
    mask = torch.tensor([True, True, True, True, True, False])
    out = masked_set_last(table, idx, vals, mask)
    ref = jnp.zeros(5, jnp.int32).at[
        jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(idx.numpy()), 5)
    ].set(jnp.asarray(vals.numpy()), mode="drop")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    uniq = masked_set(table, torch.tensor([4, 2]), torch.tensor([7, 8]),
                      torch.tensor([True, False]))
    assert uniq.tolist() == [0, 0, 0, 0, 7]
    assert table.tolist() == [0] * 5                 # functional
