"""PyTorch port parity: map capacity management, covisibility and the
resumable (chunked) LM behind the background local BA.

* ``compact_map_points``, ``compact_keyframes``, ``grow_map`` and
  ``covisibility_matrix`` on a map both packages start from (a seeded
  scene with culled points and keyframes): every table exact, floats
  included, since these only move and pad rows.
* ``ChunkedLM`` chunk by chunk against the reference's on the same window
  problem, in the window layout and in the PCG and general layouts of
  global BA: phase and remaining iterations exact; after each chunk the cost
  rtol 1e-3, poses atol 1e-4 and points atol 2e-3 (the float32 resolution
  of the depth of a landmark the window barely constrains, as in
  test_torch_mapping.py), and the between-phase inlier mask exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers as h
from torch_regime import pinned
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.frontend.extractor import (OrbParams as JP,
                                                    inv_scale_sigma2 as jinv)
from orb_slam_fusion_tpu.map import map_state as jms
from orb_slam_fusion_tpu.solver import ba as jba
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.frontend.extractor import (
    OrbParams as TP, inv_scale_sigma2 as tinv)
from orb_slam_fusion_tpu_torch.map import convert
from orb_slam_fusion_tpu_torch.map import map_state as tms
from orb_slam_fusion_tpu_torch.solver import ba as tba

torch.set_num_threads(1)


def _culled_scene(seed):
    """A seeded scene with a third of its points and two keyframes culled
    (their observations left in place, as culling leaves them)."""
    fields, _ = h.make_scene(seed, K0=8)
    rng = np.random.RandomState(seed + 100)
    n_mp = int(fields["n_mp"])
    dead = rng.rand(n_mp) < 0.33
    fields["mp_valid"][:n_mp] &= ~dead
    fields["kf_valid"][[2, 5]] = False
    fields["mp_ref_kf"][:n_mp] = rng.randint(0, 8, n_mp)
    fields["mp_first_kf"][:n_mp] = rng.randint(0, 8, n_mp)
    return fields


def _same(a, b):
    for k in a:
        if k == "kf_pose":
            np.testing.assert_array_equal(a[k][0], b[k][0], err_msg=k)
            np.testing.assert_array_equal(a[k][1], b[k][1], err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_compaction_growth_covisibility(seed):
    fields = _culled_scene(seed)
    mj = h.jax_map(fields)
    mt = convert.map_state_from_numpy(fields, "cpu")
    np.testing.assert_array_equal(np.asarray(jms.covisibility_matrix(mj)),
                                  tms.covisibility_matrix(mt).numpy())
    cj, o2n_j = jms.compact_map_points(mj)
    ct, o2n_t = tms.compact_map_points(mt)
    np.testing.assert_array_equal(np.asarray(o2n_j), o2n_t.numpy())
    _same(h.jax_map_to_numpy(cj), convert.map_state_to_numpy(ct))
    kj, ko_j, order_j = jms.compact_keyframes(cj)
    kt, ko_t, order_t = tms.compact_keyframes(ct)
    np.testing.assert_array_equal(np.asarray(ko_j), ko_t.numpy())
    np.testing.assert_array_equal(np.asarray(order_j), order_t.numpy())
    _same(h.jax_map_to_numpy(kj), convert.map_state_to_numpy(kt))
    np.testing.assert_array_equal(np.asarray(jms.covisibility_matrix(kj)),
                                  tms.covisibility_matrix(kt).numpy())
    for nk, nm in ((32, 0), (0, 1024), (32, 1024), (8, 16)):
        _same(h.jax_map_to_numpy(jms.grow_map(kj, nk, nm)),
              convert.map_state_to_numpy(tms.grow_map(kt, nk, nm)))


def _window_problems(seed):
    fields, scene = h.make_scene(seed)
    # 1 cm of noise on the points and 0.5 px on the observations: the
    # robust phase has outliers-in-waiting and real residuals
    rng = np.random.RandomState(seed + 7)
    fields["mp_pos"] = (fields["mp_pos"] + rng.randn(
        *fields["mp_pos"].shape).astype(np.float32) * 0.01)
    fields["kf_uv"] = (fields["kf_uv"] + rng.randn(
        *fields["kf_uv"].shape).astype(np.float32) * 0.5)
    W = 5
    window = np.full(W, -1, np.int32)
    window[:4] = np.arange(scene["K0"] - 4, scene["K0"])
    fixed = (np.arange(W) < 2) | (window < 0)
    cam = np.asarray(scene["cam"], np.float32)

    mj = h.jax_map(fields)
    win = jnp.asarray(window)
    kf_idx, mp_idx, uv, octv, valid = jms.observation_triples(mj, win)
    wc = jnp.clip(win, 0, mj.max_kf - 1)
    pj = jba.make_window_problem(
        jlie.SE3(mj.kf_pose.R[wc], mj.kf_pose.t[wc]), mj.mp_pos, kf_idx,
        mp_idx, uv, jinv(JP())[jnp.clip(octv, 0, 7)], valid,
        jnp.asarray(fixed), jnp.asarray(cam), window_size=W,
        fixed_point=~mj.mp_valid)

    mt = convert.map_state_from_numpy(fields, "cpu")
    wt = torch.from_numpy(window)
    kf_idx, mp_idx, uv, octv, valid = tms.observation_triples(mt, wt)
    wc = torch.clamp(wt, 0, mt.max_kf - 1).long()
    pt = tba.make_window_problem(
        tlie.SE3(mt.kf_pose.R[wc], mt.kf_pose.t[wc]), mt.mp_pos, kf_idx,
        mp_idx, uv, tinv(TP(), "cpu")[torch.clamp(octv, 0, 7).long()],
        valid, torch.from_numpy(fixed), torch.from_numpy(cam),
        window_size=W, fixed_point=~mt.mp_valid)
    return pj, pt


@pinned
@pytest.mark.parametrize("chunk", [3, 5])
def test_chunked_lm_chunk_by_chunk(chunk):
    pj, pt = _window_problems(0)
    lj = jba.ChunkedLM(pj, "pinhole", 5, 10, chunk, window_layout=True)
    lt = tba.ChunkedLM(pt, "pinhole", 5, 10, chunk, window_layout=True)
    np.testing.assert_allclose(float(lj.cost), float(lt.cost), rtol=1e-5)
    steps = 0
    while not lj.done:
        assert lj.step() == lt.step()
        steps += 1
        assert lj.phase == lt.phase and lj.left == lt.left
        np.testing.assert_allclose(float(lj.cost), float(lt.cost), rtol=1e-3)
        np.testing.assert_allclose(np.asarray(lj.poses.R), lt.poses.R.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(lj.poses.t), lt.poses.t.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(lj.points), lt.points.numpy(),
                                   atol=2e-3)
        np.testing.assert_array_equal(np.asarray(lj.inlier),
                                      lt.inlier.numpy())
    assert lt.done and steps == -(-5 // chunk) + -(-10 // chunk)
    assert float(lt.cost) < float(tba.lm_cost(pt.poses, pt.points, lt.inlier,
                                              pt, "pinhole"))


def test_chunked_lm_refuses_unported_layouts():
    """Both layouts that were refused before global BA was ported now run
    as the reference's: the matrix-free PCG step (pose_stride = the
    window's factors per row) and the dense step over the general layout
    (window_layout=False), chunk by chunk against the JAX package (poses
    1e-4, points 2e-3 as above, costs 1e-3 relative, inlier masks
    exact)."""
    pj, pt = _window_problems(1)
    stride = pt.kf_idx.shape[0] // pt.poses.t.shape[0]
    for kw in (dict(pose_stride=stride), dict(window_layout=False)):
        lj = jba.ChunkedLM(pj, "pinhole", 5, 10, 5, **kw)
        lt = tba.ChunkedLM(pt, "pinhole", 5, 10, 5, **kw)
        while not lj.done:
            assert lj.step() == lt.step()
            np.testing.assert_allclose(float(lj.cost), float(lt.cost),
                                       rtol=1e-3)
            np.testing.assert_allclose(np.asarray(lj.poses.t),
                                       lt.poses.t.numpy(), atol=1e-4)
            np.testing.assert_allclose(np.asarray(lj.poses.R),
                                       lt.poses.R.numpy(), atol=1e-4)
            np.testing.assert_allclose(np.asarray(lj.points),
                                       lt.points.numpy(), atol=2e-3)
            np.testing.assert_array_equal(np.asarray(lj.inlier),
                                          lt.inlier.numpy())
        assert lt.done
