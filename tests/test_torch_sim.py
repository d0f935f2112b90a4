"""PyTorch port parity: the synthetic worlds the monocular session runs on.

The port's ``sim.py`` (numpy only, so ``chip_smoke.py`` can run it without
JAX) is held bit-exact against ``orb_slam_fusion_tpu.sim`` on the same
seeds: world points, descriptors, ground-truth poses and canonical
distances; every ``render_frame`` array (uv, octaves, descriptors,
validity) on the tracker e2e sequence; ``render_image`` images on the
image e2e sequence; ``gt_positions``. Also the float32 pieces the
reference runs eagerly through XLA: ``so3_exp`` (glibc ``sinf``/``cosf``
inside) and the pinhole projection; ``with_viewdep_descriptors``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import cameras as jcam
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.map.convert import features_to_numpy

torch.set_num_threads(1)

CAM = (400.0, 400.0, 376.0, 240.0)
IMG_CAM = (300.0, 300.0, 188.0, 120.0)


def _same_world(wj, wt):
    for f in wj._fields:
        a, b = getattr(wj, f), getattr(wt, f)
        if f == "poses":
            np.testing.assert_array_equal(np.asarray(a.R), b.R)
            np.testing.assert_array_equal(np.asarray(a.t), b.t)
        elif a is None:
            assert b is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
    np.testing.assert_array_equal(np.asarray(jsim.gt_positions(wj)),
                                  tsim.gt_positions(wt))


def _gentle_positions(T=50):
    s = np.linspace(0, 1, T)
    return np.stack([0.5 * np.sin(2 * np.pi * s),
                     0.1 * np.sin(4 * np.pi * s), 3.0 * s],
                    axis=1).astype(np.float32)


def test_so3_exp_and_projection():
    rng = np.random.RandomState(0)
    w = (rng.randn(4000, 3) * rng.choice([1e-5, 0.05, 0.5, 2.0],
                                         (4000, 1))).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jlie.so3_exp(jnp.asarray(w))),
                                  tsim.so3_exp(w))
    pts = (rng.randn(3000, 3) * 5).astype(np.float32)
    pts[:10, 2] = 0.0
    np.testing.assert_array_equal(
        np.asarray(jcam.project("pinhole", jnp.asarray(CAM, jnp.float32),
                                jnp.asarray(pts))),
        tsim.project(CAM, pts))


@pytest.mark.parametrize("motion", ["arc", "circle", "straight"])
def test_corridor_world_and_frames(motion):
    wj = jsim.make_corridor_world(n_frames=80, n_points=4000, seed=3,
                                  motion=motion)
    wt = tsim.make_corridor_world(n_frames=80, n_points=4000, seed=3,
                                  motion=motion)
    _same_world(wj, wt)
    for k in range(0, 80, 9):
        fj = jsim.render_frame(wj, k, jnp.asarray(CAM), (480, 752), 512,
                               pixel_noise=0.3, desc_bit_flips=3,
                               dropout=0.08, seed=11)
        ft = features_to_numpy(tsim.render_frame(
            wt, k, CAM, (480, 752), 512, pixel_noise=0.3, desc_bit_flips=3,
            dropout=0.08, seed=11, device="cpu"))
        for f in fj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(fj, f)), ft[f],
                                          err_msg=f"frame {k} {f}")


def test_trajectory_world_and_images():
    pos = _gentle_positions()
    wj = jsim.world_from_trajectory(pos, n_points=2500, seed=1)
    wt = tsim.world_from_trajectory(pos, n_points=2500, seed=1)
    _same_world(wj, wt)
    for k in (0, 17, 33, 49):
        np.testing.assert_array_equal(
            jsim.render_image(wj, k, jnp.asarray(IMG_CAM, jnp.float32),
                              (240, 376)),
            tsim.render_image(wt, k, IMG_CAM, (240, 376)),
            err_msg=f"frame {k}")


def test_quaternion_world_and_viewpoint_descriptors():
    pos = _gentle_positions(20)
    q = np.random.RandomState(4).randn(20, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    wj = jsim.world_from_trajectory(pos, n_points=800, seed=2, quats_wxyz=q)
    wt = tsim.world_from_trajectory(pos, n_points=800, seed=2, quats_wxyz=q)
    _same_world(wj, wt)
    rng = np.random.RandomState(9)
    qd = jsim.make_quadrant_descriptors(wj.descriptors, rng)
    np.testing.assert_array_equal(
        qd, tsim.make_quadrant_descriptors(wt.descriptors,
                                           np.random.RandomState(9)))
    wj, wt = wj._replace(quad_desc=qd), wt._replace(quad_desc=qd)
    for k in (0, 11):
        fj = jsim.render_frame(wj, k, jnp.asarray(CAM), (480, 752), 256,
                               seed=5)
        ft = tsim.render_frame_numpy(wt, k, CAM, (480, 752), 256, seed=5)
        for f in fj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(fj, f)), ft[f],
                                          err_msg=f"frame {k} {f}")


@pytest.mark.parametrize("seed,drift_bits", [(0, 80), (7, 24)])
def test_with_viewdep_descriptors(seed, drift_bits):
    """``with_viewdep_descriptors``: the same per-quadrant descriptors
    (bit-exact), and frames rendered from them the same."""
    wj = jsim.make_corridor_world(n_frames=12, n_points=900, seed=4)
    wt = tsim.make_corridor_world(n_frames=12, n_points=900, seed=4)
    wj = jsim.with_viewdep_descriptors(wj, seed=seed, drift_bits=drift_bits)
    wt = tsim.with_viewdep_descriptors(wt, seed=seed, drift_bits=drift_bits)
    assert wt.quad_desc.dtype == np.uint32
    assert wt.quad_desc.shape == (900, 4, 8)
    _same_world(wj, wt)
    fj = jsim.render_frame(wj, 9, jnp.asarray(CAM), (480, 752), 256, seed=3)
    ft = tsim.render_frame_numpy(wt, 9, CAM, (480, 752), 256, seed=3)
    for f in fj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(fj, f)), ft[f],
                                      err_msg=f)
