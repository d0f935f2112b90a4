"""PyTorch port parity: the Kannala-Brandt 8 and radial-tangential camera
models, the simulator's fisheye renders, the KB8 monocular session and one
fisheye-stereo step from carried reference state.

Tolerances:

* ``kb8_project``, ``kb8_project_jac``, ``radtan_distort_normalized`` and
  ``undistort_points`` are bit-exact against the reference's eager calls
  (one float32 rounding per operation, glibc's ``atan2f``, a correctly
  rounded square root), degenerate points (pc = 0) included.
* ``kb8_unproject`` is bit-exact against the reference's eager call (its
  10 Newton steps in one compiled loop, which XLA fuses, and glibc's
  ``tanf``, both restated); the older check at 1e-5 relative stays.
* The simulator's KB8 renders (features and images) are bit-exact.
* One fisheye-stereo step from the reference's carried state: state,
  inliers, keyframe and map-point counts and the integer map tables
  exact, the pose within 1e-4, as the monocular steps are held; the
  virtual right-image u of the new keyframe (u_L - bf/z, z triangulated
  from the unprojected rays) within 0.01 px.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers as h
from orb_slam_fusion_tpu import cameras as jcam
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import MonoTracker as JMono
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.engine.stereo_tracker import (
    FisheyeStereoTracker as JFisheye)
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu_torch import cameras as tcam
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import MonoTracker, SlamConfig
from orb_slam_fusion_tpu_torch.engine.stereo_tracker import (
    FisheyeStereoTracker)
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.map import convert

torch.set_num_threads(2)

KB8 = (190.97847, 190.9733, 254.93170, 256.89742,
       0.0034823894, 0.00077133023, -0.0000034, 0.00000069)
T_C1_C2 = np.block([
    [np.eye(3), np.array([[0.101], [0.002], [0.001]])],
    [np.zeros((1, 3)), np.ones((1, 1))]])
RADTAN = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                  np.float32)
EUROC = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
KW = dict(cam_params=KB8, image_size=(512, 512), max_keyframes=64,
          max_map_points=6144, ba_window=6, loop_closing=False)
RENDER = dict(pixel_noise=0.3, desc_bit_flips=3, dropout=0.08)


def _points(seed, n=3000):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.0, 8.0, n)
    pts[:4] = 0.0                    # padded table slots project from 0
    pts[4:8, :2] = 0.0               # on the optical axis
    return pts


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  np.asarray(b).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_kb8_project_and_jacobian_bit_exact(seed):
    pts = _points(seed)
    cam = np.asarray(KB8, np.float32)
    for jf, tf in ((jcam.kb8_project, tcam.kb8_project),
                   (jcam.kb8_project_jac, tcam.kb8_project_jac)):
        want = jf(jnp.asarray(cam), jnp.asarray(pts))
        got = tf(torch.from_numpy(cam), torch.from_numpy(pts))
        _eq(want, got.numpy())
    assert np.isfinite(tcam.kb8_project_jac(
        torch.from_numpy(cam), torch.from_numpy(pts[:4])).numpy()).all()


def test_kb8_unproject_is_the_references_bits():
    """The eager reference call's rays bit for bit on the 4,000 rows of the
    tolerance test below: its compiled Newton loop as XLA:CPU fuses it
    (every product contracted into the add after it) and glibc's ``tanf``
    (``utils/libm.py``)."""
    rng = np.random.RandomState(2)
    uv = rng.uniform(0, 512, (4000, 2)).astype(np.float32)
    cam = np.asarray(KB8, np.float32)
    want = np.asarray(jcam.kb8_unproject(jnp.asarray(cam), jnp.asarray(uv)))
    got = tcam.kb8_unproject(torch.from_numpy(cam),
                             torch.from_numpy(uv)).numpy()
    assert (got.view(np.int32) == want.view(np.int32)).all()


def test_kb8_unproject_within_tolerance_and_round_trips():
    rng = np.random.RandomState(2)
    uv = rng.uniform(0, 512, (4000, 2)).astype(np.float32)
    cam = np.asarray(KB8, np.float32)
    want = np.asarray(jcam.kb8_unproject(jnp.asarray(cam), jnp.asarray(uv)))
    got = tcam.kb8_unproject(torch.from_numpy(cam),
                             torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # inside the model's range (theta < 1.2 rad) the ray projects back
    inside = np.hypot(got[:, 0], got[:, 1]) < np.tan(1.2)
    assert inside.mean() > 0.5
    back = tcam.kb8_project(torch.from_numpy(cam), torch.from_numpy(got))
    np.testing.assert_allclose(back.numpy()[inside], uv[inside], atol=2e-3)


def test_dispatch_by_model():
    cam = torch.tensor(KB8, dtype=torch.float32)
    pts = torch.from_numpy(_points(3, 16))
    assert torch.equal(tcam.project(tcam.KANNALA_BRANDT8, cam, pts),
                       tcam.kb8_project(cam, pts))
    assert torch.equal(tcam.project(tcam.PINHOLE, cam[:4], pts),
                       tcam.pinhole_project(cam[:4], pts))
    with pytest.raises(ValueError):
        tcam.project("double_sphere", cam, pts)
    with pytest.raises(ValueError):
        MonoTracker(SlamConfig(cam_model="double_sphere", loop_closing=False),
                    device="cpu")


@pytest.mark.parametrize("dist", [RADTAN, np.append(RADTAN, 0.01)],
                         ids=["k1k2p1p2", "with_k3"])
def test_radtan_bit_exact(dist):
    rng = np.random.RandomState(4)
    xy = rng.uniform(-1, 1, (3000, 2)).astype(np.float32)
    uv = rng.uniform(0, 752, (3000, 2)).astype(np.float32)
    dist = np.asarray(dist, np.float32)
    _eq(jcam.radtan_distort_normalized(jnp.asarray(dist), jnp.asarray(xy)),
        tcam.radtan_distort_normalized(torch.from_numpy(dist),
                                       torch.from_numpy(xy)).numpy())
    _eq(jcam.undistort_points(jnp.asarray(EUROC), jnp.asarray(dist),
                              jnp.asarray(uv)),
        tcam.undistort_points(torch.from_numpy(EUROC),
                              torch.from_numpy(dist),
                              torch.from_numpy(uv)).numpy())


def test_tracker_undistorts_keypoints_as_the_reference():
    """``MonoTracker._undistort`` with a radial-tangential ``distortion``
    (the unrectified pinhole path) gives the reference's keypoints."""
    kw = dict(cam_params=tuple(float(v) for v in EUROC),
              distortion=tuple(float(v) for v in RADTAN), loop_closing=False,
              max_keyframes=8, max_map_points=64)
    uv = np.random.RandomState(5).uniform(0, 700, (1024, 2)).astype(
        np.float32)
    fields = dict(uv=uv, response=np.ones(1024, np.float32),
                  octave=np.zeros(1024, np.int32),
                  angle=np.zeros(1024, np.float32),
                  desc=np.zeros((1024, 8), np.uint32),
                  valid=np.ones(1024, bool))
    want = JMono(JConfig(**kw))._undistort(h.jax_features(fields)).uv
    got = MonoTracker(SlamConfig(**kw), device="cpu")._undistort(
        convert.features_from_numpy(fields, "cpu")).uv
    _eq(want, got.numpy())
    assert not np.array_equal(np.asarray(want), uv)


@pytest.mark.parametrize("frame", [0, 9])
def test_fisheye_renders_bit_exact(frame):
    wj = jsim.make_corridor_world(n_frames=10, n_points=3000, seed=11)
    wt = tsim.make_corridor_world(n_frames=10, n_points=3000, seed=11)
    pj = jsim.render_fisheye_stereo_frame(wj, frame, KB8, KB8, (512, 512),
                                          512, T_C1_C2, seed=17, **RENDER)
    pt = tsim.render_fisheye_stereo_frame_numpy(
        wt, frame, KB8, KB8, (512, 512), 512, T_C1_C2, seed=17, **RENDER)
    for fj, ft in zip(pj, pt):
        assert int(ft["valid"].sum()) > 200
        for name in fj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(fj, name)),
                                          ft[name], err_msg=name)
    ij = jsim.render_image(wj, frame, jnp.asarray(KB8, jnp.float32),
                           (512, 512), cam_model=jcam.KANNALA_BRANDT8)
    it = tsim.render_image(wt, frame, KB8, (512, 512),
                           cam_model=tsim.KANNALA_BRANDT8)
    np.testing.assert_array_equal(ij, it)


def _fisheye_frames(world, k, sim_mod):
    if sim_mod is jsim:
        return jsim.render_fisheye_stereo_frame(
            world, k, KB8, KB8, KW["image_size"], 512, T_C1_C2, seed=17,
            **RENDER)
    return tsim.render_fisheye_stereo_frame(
        world, k, KB8, KB8, KW["image_size"], 512, T_C1_C2, seed=17,
        device="cpu", **RENDER)


def _row(tr, rec):
    return (rec.state, int(rec.tracked), int(tr.map.n_kf), int(tr.map.n_mp))


CARRY_AT, STEPS = 9, 2


def test_fisheye_stereo_steps_from_carried_state():
    """The fisheye-stereo session (``test_fisheye_e2e.py``'s sequence):
    the reference runs to frame 9 (its background local BA drained),
    the port takes over its state, and both step two frames, the second
    inserting a keyframe."""
    wj = jsim.make_corridor_world(n_frames=12, n_points=6000, seed=11)
    wt = tsim.make_corridor_world(n_frames=12, n_points=6000, seed=11)
    jt = JFisheye(JConfig(cam_model=jcam.KANNALA_BRANDT8,
                          orb=JOrb(n_features=512), **KW), KB8, T_C1_C2)
    for k in range(CARRY_AT):
        jt.process_stereo_features(*_fisheye_frames(wj, k, jsim),
                                   float(wj.timestamps[k]))
    snap = copy.deepcopy(jt)
    state = h.jax_tracker_state(snap)
    tt = FisheyeStereoTracker(
        SlamConfig(cam_model=tcam.KANNALA_BRANDT8,
                   orb=OrbParams(n_features=512), **KW), KB8, T_C1_C2,
        device="cpu")
    convert.tracker_state_from_numpy(tt, state)
    n_kf0 = int(tt.map.n_kf)
    for k in range(CARRY_AT, CARRY_AT + STEPS):
        rj = snap.process_stereo_features(*_fisheye_frames(wj, k, jsim),
                                          float(wj.timestamps[k]))
        rt = tt.process_stereo_features(*_fisheye_frames(wt, k, tsim),
                                        float(wt.timestamps[k]))
        assert _row(snap, rj) == _row(tt, rt), k
        np.testing.assert_allclose(np.asarray(snap.cur_pose.t),
                                   tt.cur_pose.t.numpy(), atol=1e-4)
        np.testing.assert_allclose(np.asarray(snap.cur_pose.R),
                                   tt.cur_pose.R.numpy(), atol=1e-4)
        a = h.jax_map_to_numpy(snap.map)
        b = convert.map_state_to_numpy(tt.map)
        for f in ("kf_valid", "kf_obs_mp", "mp_valid", "mp_visible",
                  "mp_found", "n_kf", "n_mp"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{k} {f}")
        np.testing.assert_array_equal(np.asarray(snap.kf_uright) > 0,
                                      tt.kf_uright.numpy() > 0)
        np.testing.assert_allclose(np.asarray(snap.kf_uright),
                                   tt.kf_uright.numpy(), atol=1e-2)
    assert int(tt.map.n_kf) > n_kf0, "no keyframe inserted in the steps"
