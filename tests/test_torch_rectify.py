"""PyTorch port parity: stereo rectification (``frontend/rectify.py``) and
the rectified-image stereo path.

Tolerances: the host part (``stereo_rectify``, ``rectify_map``: the
reference's float64 numpy, copied) is equal to the reference's arrays;
``remap_bilinear`` and ``remap_stereo_pair`` are bit-exact (each
``a * (1 - f) + b * f`` fused as XLA:CPU fuses it); and on the EuRoC rig
(the unrectified calibration of ``tests/test_settings.py``) the whole
images path, render -> remap -> ORB extraction -> ``stereo_match`` ->
``subpixel_refine``, gives the reference's keypoints, right-image u and
masks bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.frontend import rectify as jrect
from orb_slam_fusion_tpu.frontend import stereo as jst
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu.frontend.extractor import extract_features as jext
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.frontend import rectify as trect
from orb_slam_fusion_tpu_torch.frontend import stereo as tst
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.frontend.extractor import (
    extract_features as text)

torch.set_num_threads(2)

# EuRoC MAV stereo rig (tests/test_settings.py, reference EuRoC.yaml)
K1 = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
D1 = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
K2 = np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1]])
D2 = np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05])
T_C1_C2 = np.array([
    [0.999997256477797, -0.002317135723275, -0.000343393120620,
     0.110074137800478],
    [0.002312067192432, 0.999898048507103, -0.014090668452683,
     -0.000156612054392],
    [0.000376008102320, 0.014089835846691, 0.999900662638081,
     0.000889382785432],
    [0, 0, 0, 1.0]])
SIZE = (752, 480)  # (w, h)


def _maps(mod):
    T21 = np.linalg.inv(T_C1_C2)
    R1, R2, P1, P2 = mod.stereo_rectify(K1, D1, K2, D2, T21[:3, :3],
                                        T21[:3, 3], SIZE)
    return (R1, R2, P1, P2), (mod.rectify_map(K1, D1, R1, P1[:, :3], SIZE),
                              mod.rectify_map(K2, D2, R2, P2[:, :3], SIZE))


def test_rectification_maps_equal_the_references():
    (rj, mj), (rt, mt) = _maps(jrect), _maps(trect)
    for a, b in zip(rj + mj, rt + mt):
        np.testing.assert_array_equal(a, b)
    v = np.array([0.3, -0.2, 0.1])
    np.testing.assert_array_equal(jrect._rodrigues(v), trect._rodrigues(v))
    R = trect._rodrigues(v)
    np.testing.assert_array_equal(jrect._rodrigues_inv(R),
                                  trect._rodrigues_inv(R))


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_bilinear_bit_exact(seed):
    """Random images and maps reaching past every border (taps outside
    read 0), a batched image stack included."""
    rng = np.random.RandomState(seed)
    h, w = 90, 130
    img = (rng.rand(2, h, w) * 255).astype(np.float32)
    mp = np.stack([rng.uniform(-3, w + 2, (h, w)),
                   rng.uniform(-3, h + 2, (h, w))], -1).astype(np.float32)
    mp[:5] = np.round(mp[:5])                  # integer taps
    want = np.asarray(jrect.remap_bilinear(jnp.asarray(img),
                                           jnp.asarray(mp)))
    got = trect.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mp))
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))


def test_rectified_image_pair_path_bit_exact():
    """A stereo pair rendered at 480x752, remapped through the EuRoC
    rectification maps, extracted and associated: the same bits at every
    stage as the reference's."""
    _, (mL, mR) = _maps(trect)
    cam = (458.654, 457.296, 367.215, 248.375)
    wj = jsim.make_corridor_world(n_frames=6, n_points=4000, seed=7)
    wt = tsim.make_corridor_world(n_frames=6, n_points=4000, seed=7)
    right = jlie.SE3(wj.poses.R[5],
                     wj.poses.t[5] + jnp.array([-0.11, 0.0, 0.0]))
    raw_j = [jsim.render_image(wj, 5, jnp.asarray(cam), (480, 752)),
             jsim.render_image(wj, 5, jnp.asarray(cam), (480, 752),
                               pose_override=right)]
    raw_t = [tsim.render_image(wt, 5, cam, (480, 752)),
             tsim.render_image(wt, 5, cam, (480, 752), pose_override=(
                 tsim.stereo_right_pose(wt, 5, 0.11)))]
    for a, b in zip(raw_j, raw_t):
        np.testing.assert_array_equal(a, b)
    ij = jrect.remap_stereo_pair(*(jnp.asarray(a) for a in raw_j + [mL, mR]))
    it = trect.remap_stereo_pair(*(torch.from_numpy(a)
                                   for a in raw_t + [mL, mR]))
    for a, b in zip(ij, it):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    fj = [jext(a, JOrb(n_features=1024)) for a in ij]
    ft = [text(a, OrbParams(n_features=1024)) for a in it]
    for a, b in zip(fj, ft):
        for name in a._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, name)).view(np.int32)
                if name == "desc" else np.asarray(getattr(a, name)),
                getattr(b, name).numpy(), err_msg=name)
    ur_j, ok_j = jst.stereo_match(*fj)
    ur_t, ok_t = tst.stereo_match(*ft)
    assert int(ok_t.sum()) > 100
    rj = jst.subpixel_refine(ij[0], ij[1], fj[0].uv, ur_j, ok_j)
    rt = tst.subpixel_refine(it[0], it[1], ft[0].uv, ur_t, ok_t)
    for a, b in zip((ur_j, ok_j) + tuple(rj), (ur_t, ok_t) + tuple(rt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(rt[1].sum()) > 50
