"""PyTorch port parity: pose optimisation and the fused tracking step.

A seeded scene (tests/test_torch_helpers.py) goes to both packages as the
same numpy arrays. The reference runs its dense XLA matcher
(``use_pallas=False``); the port, on the CPU, runs the masked-match
kernel's plain version, which test_torch_match.py holds bit-exact against
both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers as h
from orb_slam_fusion_tpu.engine import step as jstep
from orb_slam_fusion_tpu.frontend.extractor import (OrbParams as JP,
                                                    inv_scale_sigma2 as jinv)
from orb_slam_fusion_tpu.solver import pose_opt as jpo
from orb_slam_fusion_tpu_torch.engine import step as tstep
from orb_slam_fusion_tpu_torch.frontend import masked_match as tmm
from orb_slam_fusion_tpu_torch.frontend.extractor import (
    OrbParams as TP, inv_scale_sigma2 as tinv)
from orb_slam_fusion_tpu_torch.map import convert
from orb_slam_fusion_tpu_torch.solver import pose_opt as tpo

torch.set_num_threads(1)

POSE_ATOL = 1e-4


def _frame(seed, famine=False):
    fields, scene = h.make_scene(seed)
    R, t = h.kf_pose(scene["K0"])
    R = R @ h.rot([0.01, 0.02, -0.01])
    t = (t + np.array([0.02, 0.01, 0.03], np.float32)).astype(np.float32)
    feats = h.frame_features(scene, R, t)
    if famine:   # keep only a handful of features: coarse stage starves
        feats["valid"][12:] = False
    return fields, scene, feats, (R, t)


@pytest.mark.parametrize("seed,famine", [(0, False), (1, False), (2, True)])
def test_fused_frame_update_matches_reference(seed, famine):
    """obs / counts / mp_visible / mp_found exact, pose atol 1e-4; the
    famine case exercises the widened retry."""
    fields, scene, feats, truth = _frame(seed, famine)
    cam = np.asarray(scene["cam"], np.float32)
    pR, pt = h.kf_pose(scene["K0"] - 1)
    mj = h.jax_map(fields)
    mt = convert.map_state_from_numpy(fields, "cpu")
    fj = h.jax_features(feats)
    ft = convert.features_from_numpy(feats, "cpu")
    kw = dict(img_h=scene["H"], img_w=scene["W"])
    uj = jstep.fused_frame_update(
        mj.mp_pos, mj.mp_desc, mj.mp_valid, mj.mp_visible + 0,
        mj.mp_found + 0, h.jse3(pR, pt), h.jse3(pR, pt), fj.uv, fj.desc,
        fj.valid, fj.octave, jinv(JP()), jnp.asarray(cam),
        mp_normal=mj.mp_normal, mp_min_dist=mj.mp_min_dist,
        mp_max_dist=mj.mp_max_dist, use_pallas=False, **kw)
    vis, found = mt.mp_visible.clone(), mt.mp_found.clone()
    before = tmm.launches
    ut = tstep.fused_frame_update(
        mt.mp_pos, mt.mp_desc, mt.mp_valid, vis, found, h.tse3(pR, pt),
        h.tse3(pR, pt), ft.uv, ft.desc, ft.valid, ft.octave,
        tinv(TP(), "cpu"), torch.from_numpy(cam), mp_normal=mt.mp_normal,
        mp_min_dist=mt.mp_min_dist, mp_max_dist=mt.mp_max_dist, **kw)
    assert tmm.launches == before                  # CPU: plain version
    np.testing.assert_array_equal(np.asarray(uj.counts), ut.counts.numpy())
    np.testing.assert_array_equal(np.asarray(uj.obs), ut.obs.numpy())
    np.testing.assert_array_equal(np.asarray(uj.mp_visible),
                                  ut.mp_visible.numpy())
    np.testing.assert_array_equal(np.asarray(uj.mp_found),
                                  ut.mp_found.numpy())
    assert ut.mp_visible is vis and ut.mp_found is found   # in place
    for a, b in ((uj.pose.R, ut.pose.R), (uj.pose.t, ut.pose.t),
                 (uj.velocity.t, ut.velocity.t)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=POSE_ATOL)
    n_match, n_in = ut.counts.tolist()
    if famine:
        assert 0 < n_match < 20
    else:
        assert n_in > 60
        np.testing.assert_allclose(ut.pose.t.numpy(), truth[1], atol=0.05)


def test_pose_optimization_matches_reference():
    """Pose atol 1e-4, inlier mask and count exact, with 20% outliers."""
    rng = np.random.RandomState(7)
    N = 200
    cam = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                  rng.uniform(4, 10, N)], 1).astype(np.float32)
    R = h.rot([0.02, -0.03, 0.01])
    t = np.array([0.1, -0.05, 0.2], np.float32)
    pc = X @ R.T + t
    uv = np.stack([cam[0] * pc[:, 0] / pc[:, 2] + cam[2],
                   cam[1] * pc[:, 1] / pc[:, 2] + cam[3]], 1)
    uv = (uv + rng.randn(N, 2) * 0.5).astype(np.float32)
    uv[:40] += rng.uniform(-40, 40, (40, 2)).astype(np.float32)
    valid = rng.rand(N) > 0.05
    inv_s2 = (1.0 / 1.44 ** rng.randint(0, 3, N)).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    zero = np.zeros(3, np.float32)
    pj, ij, nj = jpo.pose_optimization(
        h.jse3(eye, zero), jnp.asarray(X), jnp.asarray(uv),
        jnp.asarray(inv_s2), jnp.asarray(valid), jnp.asarray(cam))
    pt_, it, nt = tpo.pose_optimization(
        h.tse3(eye, zero), torch.from_numpy(X), torch.from_numpy(uv),
        torch.from_numpy(inv_s2), torch.from_numpy(valid),
        torch.from_numpy(cam))
    np.testing.assert_allclose(np.asarray(pj.R), pt_.R.numpy(),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(np.asarray(pj.t), pt_.t.numpy(),
                               atol=POSE_ATOL)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    assert int(nj) == int(nt) and 120 < int(nt) < 170


def test_fused_track_step_matches_reference():
    """The reference's compile-check step: pose atol 1e-4; inliers,
    n_inliers and matched_feat exact."""
    fields, scene, feats, _ = _frame(3)
    cam = np.asarray(scene["cam"], np.float32)
    pR, pt = h.kf_pose(scene["K0"] - 1)
    mj = h.jax_map(fields)
    mt = convert.map_state_from_numpy(fields, "cpu")
    fj = h.jax_features(feats)
    ft = convert.features_from_numpy(feats, "cpu")
    inv_s2 = np.ones(scene["F"], np.float32)
    kw = dict(img_h=scene["H"], img_w=scene["W"])
    rj = jstep.fused_track_step(
        mj.mp_pos, mj.mp_desc, mj.mp_valid, h.jse3(pR, pt), h.jse3(pR, pt),
        fj.uv, fj.desc, fj.valid, fj.octave, jnp.asarray(inv_s2),
        jnp.asarray(cam), **kw)
    rt = tstep.fused_track_step(
        mt.mp_pos, mt.mp_desc, mt.mp_valid, h.tse3(pR, pt), h.tse3(pR, pt),
        ft.uv, ft.desc, ft.valid, ft.octave, torch.from_numpy(inv_s2),
        torch.from_numpy(cam), **kw)
    np.testing.assert_allclose(np.asarray(rj.pose.t), rt.pose.t.numpy(),
                               atol=POSE_ATOL)
    np.testing.assert_array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    np.testing.assert_array_equal(np.asarray(rj.matched_feat),
                                  rt.matched_feat.numpy())
    assert int(rj.n_inliers) == int(rt.n_inliers) > 50


@pytest.mark.parametrize("fused_inside", [True, False],
                         ids=["inside-fused", "inside-term-by-term"])
def test_window_edge_rounds_as_reference(fused_inside):
    """Map points whose only keypoint sits where the squared distance's two
    roundings straddle the window's edge r*r (ROADMAP C11): the reference's
    jitted step tests ``fma(dv, dv, du*du) <= r*r``, so its coarse stage
    matches exactly the points inside by that rounding, and the port's
    step (fused-window mode) matches the same ones."""
    mp_pos, desc, kp = h.window_edge_scene(fused_inside)
    n = len(mp_pos)
    cam = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    octave = np.zeros(n, np.int32)
    kw = dict(img_h=2000, img_w=2000, radius_coarse=15.0, min_matches=0)
    uj = jstep.fused_frame_update(
        jnp.asarray(mp_pos), jnp.asarray(desc), jnp.ones(n, bool),
        jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
        h.jse3(eye, zero), h.jse3(eye, zero), jnp.asarray(kp),
        jnp.asarray(desc), jnp.ones(n, bool), jnp.asarray(octave),
        jinv(JP()), jnp.asarray(cam), use_pallas=False, **kw)
    t = torch.from_numpy
    ut = tstep.fused_frame_update(
        t(mp_pos), t(desc.view(np.int32)), torch.ones(n, dtype=torch.bool),
        torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
        h.tse3(eye, zero), h.tse3(eye, zero), t(kp), t(desc.view(np.int32)),
        torch.ones(n, dtype=torch.bool), t(octave), tinv(TP(), "cpu"),
        t(cam), **kw)
    assert int(np.asarray(uj.counts)[0]) == (n if fused_inside else 0)
    assert int(ut.counts[0]) == int(np.asarray(uj.counts)[0])
