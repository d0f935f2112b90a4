"""PyTorch port parity: stereo association (``frontend/stereo.py``), the
stereo factor of bundle adjustment, the stereo renderers, the stereo
tracker's capacity hooks and one RGB-D step from carried reference state.

Tolerances:

* ``stereo_match``: right-image u and ``has_stereo`` bit-exact (the row
  tolerance ``2 * 1.2 ** octave`` rounded as XLA rounds it; octaves 0-7
  with row offsets on both sides of it).
* ``subpixel_refine``: refined u and the kept mask bit-exact (each SAD
  summed in XLA's row-major order).
* ``depth_from_disparity`` bit-exact; ``fisheye_stereo_match`` (test
  ``test_fisheye_e2e.py``'s exact-geometry case and rendered KB8 pairs):
  the match mask exact, depths within 5e-3 relative (the rays come from the
  Newton unprojection, 1e-5 relative, see ``test_torch_cameras_kb8.py``,
  and a 10 cm baseline amplifies a ray's angle error by z / b: 0.2% at
  11 m), and the accepted sets differ in at most 2 of 512 features, each
  a reprojection error on its gate.
* The stereo BA factor: residuals, Jacobians and costs within 1e-4
  relative; the inlier classification exact; one local BA with stereo
  factors moves poses and points as the reference's within 1e-4.
* The stereo renderers: bit-exact.
* One RGB-D step from carried state: as the monocular steps (state,
  inliers, counts, integer tables exact; pose 1e-4).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers as h
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.engine.stereo_tracker import RgbdTracker as JRgbd
from orb_slam_fusion_tpu.engine.stereo_tracker import StereoTracker as JStereo
from orb_slam_fusion_tpu.frontend import stereo as jst
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu.map import map_state as jms
from orb_slam_fusion_tpu.solver import ba as jba
from orb_slam_fusion_tpu.solver import local_ba as jlba
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import SlamConfig
from orb_slam_fusion_tpu_torch.engine.stereo_tracker import (
    RgbdTracker, StereoTracker)
from orb_slam_fusion_tpu_torch.frontend import stereo as tst
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.map import convert
from orb_slam_fusion_tpu_torch.map import map_state as tms
from orb_slam_fusion_tpu_torch.solver import ba as tba
from orb_slam_fusion_tpu_torch.solver import local_ba as tlba

torch.set_num_threads(2)

CAM = (400.0, 400.0, 376.0, 240.0)
KB8 = (190.97847, 190.9733, 254.93170, 256.89742,
       0.0034823894, 0.00077133023, -0.0000034, 0.00000069)
T_C1_C2 = np.block([
    [np.eye(3), np.array([[0.101], [0.002], [0.001]])],
    [np.zeros((1, 3)), np.ones((1, 1))]])
RENDER = dict(pixel_noise=0.3, desc_bit_flips=3, dropout=0.08)
KW = dict(cam_params=CAM, image_size=(480, 752), max_keyframes=64,
          max_map_points=6144, ba_window=6, loop_closing=False)


def _eq(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _pair(world_seed, frame, n_feat=512):
    wj = jsim.make_corridor_world(n_frames=frame + 1, n_points=5000,
                                  seed=world_seed)
    wt = tsim.make_corridor_world(n_frames=frame + 1, n_points=5000,
                                  seed=world_seed)
    pj = jsim.render_stereo_frame(wj, frame, jnp.asarray(CAM), (480, 752),
                                  n_feat, 0.11, seed=31, **RENDER)
    pt = tsim.render_stereo_frame_numpy(wt, frame, CAM, (480, 752), n_feat,
                                        0.11, seed=31, **RENDER)
    return pj, pt


@pytest.mark.parametrize("frame", [0, 30])
def test_stereo_renders_and_stereo_match_bit_exact(frame):
    pj, pt = _pair(7, frame)
    for fj, ft in zip(pj, pt):
        for name in fj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(fj, name)),
                                          ft[name], err_msg=name)
    ur_j, ok_j = jst.stereo_match(*pj)
    ur_t, ok_t = tst.stereo_match(*(convert.features_from_numpy(f, "cpu")
                                    for f in pt))
    assert int(ok_t.sum()) > 300
    _eq(ok_j, ok_t.numpy())
    _eq(ur_j, ur_t.numpy())


def _row_tolerance_case(seed):
    """Right keypoints exactly on, 1 ulp inside, 1 ulp outside and 1e-5
    inside each octave's row tolerance, with 1-bit descriptor noise,
    neighbouring octaves and a few invalid left keypoints."""
    rng = np.random.RandomState(seed)
    n = 256
    octv = np.arange(n, dtype=np.int32) % 8
    uvL = np.stack([rng.uniform(200, 700, n), rng.uniform(20, 460, n)],
                   1).astype(np.float32)
    tol = (np.float32(2.0) * np.array(
        [np.float32(np.float32(1.2) ** np.float32(k)) for k in octv],
        np.float32)).astype(np.float32)
    dv = np.where(rng.rand(n) < 0.5, -1.0, 1.0).astype(np.float32) * tol
    kind = np.arange(n) % 4
    dv = np.where(kind == 0, np.nextafter(dv, np.float32(0)), dv)
    dv = np.where(kind == 1, np.nextafter(dv, np.float32(np.inf) * dv), dv)
    dv = np.where(kind == 2, dv * np.float32(1 - 1e-5), dv)
    uvR = np.stack([uvL[:, 0] - rng.uniform(0.05, 140, n),
                    uvL[:, 1] + dv], 1).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)
    descR = desc.copy()
    flip = rng.randint(0, 32, n).astype(np.uint32)
    descR[np.arange(n), rng.randint(0, 8, n)] ^= np.uint32(1) << flip
    perm = rng.permutation(n)
    validL = rng.rand(n) > 0.05

    def f(uv, d, o, v):
        return dict(uv=uv, response=np.ones(n, np.float32), octave=o,
                    angle=np.zeros(n, np.float32), desc=d, valid=v)

    octR = np.clip(octv + rng.randint(-1, 2, n), 0, 7).astype(np.int32)
    return (f(uvL, desc, octv, validL),
            f(uvR[perm], descR[perm], octR[perm], np.ones(n, bool)))


@pytest.mark.parametrize("seed", [0, 1])
def test_stereo_match_on_row_tolerance_edges(seed):
    fL, fR = _row_tolerance_case(seed)
    ur_j, ok_j = jst.stereo_match(h.jax_features(fL), h.jax_features(fR))
    ur_t, ok_t = tst.stereo_match(convert.features_from_numpy(fL, "cpu"),
                                  convert.features_from_numpy(fR, "cpu"))
    assert 0 < int(ok_t.sum()) < 256
    _eq(ok_j, ok_t.numpy())
    _eq(ur_j, ur_t.numpy())


def _images(frame, seed_world=7):
    cam, size = (300.0, 300.0, 188.0, 120.0), (240, 376)
    wj = jsim.make_corridor_world(n_frames=frame + 1, n_points=3000,
                                  seed=seed_world)
    wt = tsim.make_corridor_world(n_frames=frame + 1, n_points=3000,
                                  seed=seed_world)
    right = jlie.SE3(wj.poses.R[frame],
                     wj.poses.t[frame] + jnp.array([-0.11, 0.0, 0.0]))
    ij = [jsim.render_image(wj, frame, jnp.asarray(cam), size),
          jsim.render_image(wj, frame, jnp.asarray(cam), size,
                            pose_override=right)]
    it = [tsim.render_image(wt, frame, cam, size),
          tsim.render_image(wt, frame, cam, size, pose_override=(
              tsim.stereo_right_pose(wt, frame, 0.11)))]
    return ij, it


@pytest.mark.parametrize("frame", [3, 12])
def test_subpixel_refine_bit_exact(frame):
    """Refinement on a rendered image pair (the right camera shifted by
    the baseline) at seeded keypoints and disparities."""
    ij, it = _images(frame)
    for a, b in zip(ij, it):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(frame)
    n = 400
    uvL = np.stack([rng.uniform(0, 376, n), rng.uniform(0, 240, n)],
                   1).astype(np.float32)
    ur = (uvL[:, 0] - rng.uniform(1, 30, n)).astype(np.float32)
    ok = rng.rand(n) > 0.1
    want = jst.subpixel_refine(jnp.asarray(ij[0]), jnp.asarray(ij[1]),
                               jnp.asarray(uvL), jnp.asarray(ur),
                               jnp.asarray(ok))
    got = tst.subpixel_refine(torch.from_numpy(it[0]),
                              torch.from_numpy(it[1]), torch.from_numpy(uvL),
                              torch.from_numpy(ur), torch.from_numpy(ok))
    assert 20 < int(got[1].sum()) < n
    _eq(want[1], got[1].numpy())
    _eq(want[0], got[0].numpy())


def test_depth_from_disparity_bit_exact():
    rng = np.random.RandomState(3)
    uL = rng.uniform(0, 752, 1000).astype(np.float32)
    uR = (uL - rng.uniform(-1, 100, 1000)).astype(np.float32)
    has = rng.rand(1000) > 0.2
    for bf in (44.0, 0.11 * 458.654):
        _eq(jst.depth_from_disparity(jnp.asarray(uL), jnp.asarray(uR), bf,
                                     jnp.asarray(has)),
            tst.depth_from_disparity(torch.from_numpy(uL),
                                     torch.from_numpy(uR), bf,
                                     torch.from_numpy(has)).numpy())


def _fisheye_check(fL, fR, R21, t21, lap=((0.0, 1e9), (0.0, 1e9))):
    jd, jok = jst.fisheye_stereo_match(
        h.jax_features(fL), h.jax_features(fR), jnp.asarray(KB8),
        jnp.asarray(KB8), jnp.asarray(R21), jnp.asarray(t21), *lap)
    td, tok = tst.fisheye_stereo_match(
        convert.features_from_numpy(fL, "cpu"),
        convert.features_from_numpy(fR, "cpu"),
        torch.tensor(KB8, dtype=torch.float32),
        torch.tensor(KB8, dtype=torch.float32), torch.from_numpy(R21),
        torch.from_numpy(t21), *lap)
    jok, tok = np.asarray(jok), tok.numpy()
    both = jok & tok
    np.testing.assert_allclose(td.numpy()[both], np.asarray(jd)[both],
                               rtol=5e-3)
    return jok, tok


def test_fisheye_stereo_match_exact_geometry():
    """``test_fisheye_e2e.py``'s exact-geometry case: 128 points projected
    into both KB8 cameras with shared descriptors, the right set shuffled."""
    from orb_slam_fusion_tpu import cameras as jcam
    rng = np.random.RandomState(3)
    N = 128
    cam = jnp.asarray(KB8)
    pts = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(1.0, 8.0, N)
    T21 = np.linalg.inv(T_C1_C2)
    pts_r = pts @ T21[:3, :3].T + T21[:3, 3]
    uvL = np.asarray(jcam.project(jcam.KANNALA_BRANDT8, cam,
                                  jnp.asarray(pts)))
    uvR = np.asarray(jcam.project(jcam.KANNALA_BRANDT8, cam,
                                  jnp.asarray(pts_r.astype(np.float32))))
    desc = rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(
        np.uint32)
    perm = rng.permutation(N)

    def mk(uv, d):
        return dict(uv=uv, response=np.ones(N, np.float32),
                    octave=np.zeros(N, np.int32),
                    angle=np.zeros(N, np.float32), desc=d,
                    valid=np.ones(N, bool))

    jok, tok = _fisheye_check(mk(uvL, desc), mk(uvR[perm], desc[perm]),
                              T21[:3, :3].astype(np.float32),
                              T21[:3, 3].astype(np.float32))
    assert tok.sum() > N * 0.9
    np.testing.assert_array_equal(jok, tok)


@pytest.mark.parametrize("frame", [0, 20])
def test_fisheye_stereo_match_on_rendered_pairs(frame):
    wt = tsim.make_corridor_world(n_frames=frame + 1, n_points=6000, seed=11)
    fL, fR = tsim.render_fisheye_stereo_frame_numpy(
        wt, frame, KB8, KB8, (512, 512), 512, T_C1_C2, seed=17, **RENDER)
    T21 = np.linalg.inv(T_C1_C2)
    jok, tok = _fisheye_check(fL, fR, T21[:3, :3].astype(np.float32),
                              T21[:3, 3].astype(np.float32),
                              ((0.0, 512.0), (0.0, 512.0)))
    assert tok.sum() > 150
    # the accepted sets may part only on a gate within 1% of its threshold
    assert (jok != tok).sum() <= 2, np.nonzero(jok != tok)


def _stereo_window_problem(seed):
    """A BA window of ``test_torch_helpers.make_scene`` with a right-image
    u for 70% of the observations (the true one plus 0.3 px noise)."""
    fields, scene = h.make_scene(seed, K0=6)
    m = convert.map_state_from_numpy(fields, "cpu")
    rng = np.random.RandomState(seed + 100)
    bf = 0.11 * scene["cam"][0]
    K, F = m.max_kf, m.n_feat
    kf_ur = np.full((K, F), -1.0, np.float32)
    pts = scene["pts"]
    for k in range(6):
        R, t = h.kf_pose(k)
        obs = fields["kf_obs_mp"][k]
        sel = (obs >= 0) & (rng.rand(F) < 0.7)
        pc = pts[obs[sel]] @ R.T + t
        kf_ur[k, sel] = (fields["kf_uv"][k, sel, 0] - bf / pc[:, 2]
                         + rng.randn(sel.sum()) * 0.3).astype(np.float32)
    window = np.array([0, 1, 2, 3, 4, 5, -1, -1], np.int32)
    fixed = np.array([1, 0, 0, 0, 0, 0, 1, 1], bool)
    return fields, kf_ur, bf, window, fixed


def _problems(fields, kf_ur, bf, window, fixed):
    inv = np.ones(8, np.float32) / (1.2 ** (2 * np.arange(8))).astype(
        np.float32)
    jm = h.jax_map(fields)
    kf_idx, mp_idx, uv, octv, valid = jms.observation_triples(
        jm, jnp.asarray(window))
    wclip = jnp.clip(jnp.asarray(window), 0, jm.max_kf - 1)
    ur = jnp.asarray(kf_ur)[wclip].reshape(-1)
    pj = jba.make_window_problem(
        jlie.SE3(jm.kf_pose.R[wclip], jm.kf_pose.t[wclip]), jm.mp_pos,
        kf_idx, mp_idx, uv, jnp.asarray(inv)[octv], valid,
        jnp.asarray(fixed) | (jnp.asarray(window) < 0),
        jnp.asarray(h.CAM_SMALL), window_size=len(window),
        fixed_point=~jm.mp_valid, u_right=ur, stereo_mask=valid & (ur > 0),
        bf=bf)
    tm = convert.map_state_from_numpy(fields, "cpu")
    w = torch.from_numpy(window)
    kf_idx, mp_idx, uv, octv, valid = tms.observation_triples(tm, w)
    wc = torch.clamp(w, 0, tm.max_kf - 1).long()
    pt = tba.make_window_problem(
        tlie.SE3(tm.kf_pose.R[wc], tm.kf_pose.t[wc]), tm.mp_pos, kf_idx,
        mp_idx, uv, torch.from_numpy(inv)[octv.long()], valid,
        torch.from_numpy(fixed) | (w < 0),
        torch.tensor(h.CAM_SMALL, dtype=torch.float32),
        window_size=len(window), fixed_point=~tm.mp_valid,
        **tlba.stereo_args(torch.from_numpy(kf_ur), bf, wc, valid))
    return pj, pt


def test_stereo_ba_factor_matches_reference():
    fields, kf_ur, bf, window, fixed = _stereo_window_problem(5)
    pj, pt = _problems(fields, kf_ur, bf, window, fixed)
    assert int(pt.stereo_mask.sum()) > 200
    rj, Jpj, Jlj, fj = jba._eval_factors(pj.poses, pj.points, pj, "pinhole")
    rt, Jpt, Jlt, ft = tba._eval_factors(pt.poses, pt.points, pt, "pinhole")
    assert rt.shape[-1] == 3
    _eq(fj, ft.numpy())
    for a, b in ((rj, rt), (Jpj, Jpt), (Jlj, Jlt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)
    inl = torch.ones_like(pt.valid)
    np.testing.assert_allclose(
        float(tba.lm_cost(pt.poses, pt.points, inl, pt, "pinhole")),
        float(jba.lm_cost(pj.poses, pj.points, jnp.asarray(inl.numpy()), pj,
                          "pinhole")), rtol=1e-4)
    _eq(jba.inlier_mask(pj.poses, pj.points, pj, "pinhole"),
        tba.inlier_mask(pt.poses, pt.points, pt, "pinhole").numpy())
    _eq(jba._factor_chi2_th(pj, 5.991),
        tba._factor_chi2_th(pt, 5.991).numpy())


def test_stereo_local_ba_matches_reference():
    fields, kf_ur, bf, window, fixed = _stereo_window_problem(6)
    inv = jnp.asarray(np.ones(8, np.float32) / (1.2 ** (2 * np.arange(8)))
                      .astype(np.float32))
    mj, cj, nj = jlba.local_ba_step(
        h.jax_map(fields), jnp.asarray(window), jnp.asarray(fixed), inv,
        jnp.asarray(h.CAM_SMALL), kf_uright=jnp.asarray(kf_ur), bf=bf)
    mt, ct, nt = tlba.local_ba_step(
        convert.map_state_from_numpy(fields, "cpu"),
        torch.from_numpy(window), torch.from_numpy(fixed),
        torch.from_numpy(np.array(inv)),
        torch.tensor(h.CAM_SMALL, dtype=torch.float32),
        kf_uright=torch.from_numpy(kf_ur), bf=bf)
    assert int(nj) == int(nt)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4)
    h.assert_map_close(h.jax_map_to_numpy(mj),
                       convert.map_state_to_numpy(mt), atol=1e-4)


def test_capacity_hooks_move_the_right_u_rows():
    """Keyframe compaction permutes ``kf_uright`` with the keyframes and
    growth pads it with -1 rows, as the reference's hooks do."""
    jt = JStereo(JConfig(orb=JOrb(n_features=16), max_keyframes=6,
                         max_map_points=64, loop_closing=False), 0.11)
    tt = StereoTracker(SlamConfig(orb=OrbParams(n_features=16),
                                  max_keyframes=6, max_map_points=64,
                                  loop_closing=False), 0.11, device="cpu")
    table = np.random.RandomState(0).uniform(1, 700, (6, 16)).astype(
        np.float32)
    jt.kf_uright = jnp.asarray(table)
    tt.kf_uright = torch.from_numpy(table.copy())
    order = np.array([0, 2, 3, 5, 1, 4])
    jt._on_kf_remap(None, order)
    tt._on_kf_remap(None, order)
    jt._on_kf_grow(9)
    tt._on_kf_grow(9)
    _eq(jt.kf_uright, tt.kf_uright.numpy())
    assert tt.kf_uright.shape == (9, 16)
    # a merge that appends the active map's 4 keyframes after 3 archived
    # ones (the welded map grown to 12 rows): its rows shift by the
    # offset and the archived rows become monocular (-1), as the
    # reference's hook moves them
    jt.map = jt.map._replace(n_kf=jnp.int32(7))
    jt.map = jt.map._replace(kf_valid=jnp.zeros(12, bool))
    tt.map = tt.map._replace(n_kf=torch.tensor(7, dtype=torch.int32),
                             kf_valid=torch.zeros(12, dtype=torch.bool))
    jt._on_maps_merged(None, 3, None)
    tt._on_maps_merged(None, 3, None)
    _eq(jt.kf_uright, tt.kf_uright.numpy())
    assert tt.kf_uright.shape == (12, 16)
    assert (tt.kf_uright[:3] == -1).all() and (tt.kf_uright[7:] == -1).all()


def _rgbd_inputs(world, k, rng, sim_mod):
    """The RGB-D e2e test's frame: rendered features and the nearest
    projected point's depth with 0.5% noise (numpy on the port's sim)."""
    if sim_mod is jsim:
        f = jsim.render_frame(world, k, jnp.asarray(CAM), (480, 752), 512,
                              seed=41, **RENDER)
        fuv = np.asarray(f.uv)
    else:
        f = tsim.render_frame(world, k, CAM, (480, 752), 512, seed=41,
                              device="cpu", **RENDER)
        fuv = f.uv.numpy()
    pc = tsim.se3_apply(tsim.SE3(np.asarray(world.poses.R[k]),
                                 np.asarray(world.poses.t[k])),
                        np.asarray(world.points))
    uvw = tsim.project(CAM, pc)
    d2 = ((fuv[:, None, :] - uvw[None, :, :]) ** 2).sum(-1)
    d2[:, pc[:, 2] < 0.1] = 1e12
    nearest = d2.argmin(axis=1)
    depth = pc[nearest, 2] * (1.0 + rng.randn(len(nearest)) * 0.005)
    depth = np.where(d2[np.arange(len(nearest)), nearest] < 9.0, depth,
                     -1.0).astype(np.float32)
    return f, depth


def _row(tr, rec):
    return (rec.state, int(rec.tracked), int(tr.map.n_kf), int(tr.map.n_mp))


def test_rgbd_steps_from_carried_state():
    """``test_rgbd_e2e.py``'s sequence: the reference runs to frame 7 (its
    background BA drained), the port takes over its state and both step
    two frames, the second inserting a keyframe."""
    carry, steps = 7, 2
    wj = jsim.make_corridor_world(n_frames=carry + steps, n_points=5000,
                                  seed=9)
    wt = tsim.make_corridor_world(n_frames=carry + steps, n_points=5000,
                                  seed=9)
    jt = JRgbd(JConfig(orb=JOrb(n_features=512), **KW), baseline=0.08)
    rng_j = np.random.RandomState(5)
    for k in range(carry):
        f, d = _rgbd_inputs(wj, k, rng_j, jsim)
        jt.process_rgbd_features(f, jnp.asarray(d), float(wj.timestamps[k]))
    snap = copy.deepcopy(jt)
    state = h.jax_tracker_state(snap)
    tt = RgbdTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                     baseline=0.08, device="cpu")
    convert.tracker_state_from_numpy(tt, state)
    rng_t = copy.deepcopy(rng_j)
    n_kf0 = int(tt.map.n_kf)
    for k in range(carry, carry + steps):
        f, d = _rgbd_inputs(wj, k, rng_j, jsim)
        rj = snap.process_rgbd_features(f, jnp.asarray(d),
                                        float(wj.timestamps[k]))
        g, e = _rgbd_inputs(wt, k, rng_t, tsim)
        np.testing.assert_array_equal(d, e)
        rt = tt.process_rgbd_features(g, torch.from_numpy(e),
                                      float(wt.timestamps[k]))
        assert _row(snap, rj) == _row(tt, rt), k
        np.testing.assert_allclose(np.asarray(snap.cur_pose.t),
                                   tt.cur_pose.t.numpy(), atol=1e-4)
        np.testing.assert_allclose(np.asarray(snap.cur_pose.R),
                                   tt.cur_pose.R.numpy(), atol=1e-4)
        a = h.jax_map_to_numpy(snap.map)
        b = convert.map_state_to_numpy(tt.map)
        for fld in ("kf_valid", "kf_obs_mp", "mp_valid", "mp_visible",
                    "mp_found", "n_kf", "n_mp"):
            np.testing.assert_array_equal(a[fld], b[fld], err_msg=fld)
        _eq(snap.kf_uright, tt.kf_uright.numpy())
    assert int(tt.map.n_kf) > n_kf0, "no keyframe inserted in the steps"
