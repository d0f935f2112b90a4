"""Card-only tests of the port's CUDA kernel (marker ``cuda``).

They skip on a host without a CUDA device and nvcc. On the card, whose
Python has no JAX, run them without the suite's conftest (which imports
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same comparison at the main path's full shapes.
The adversarial cases (``torch_match_cases.py``) are the ones the CPU
tests hold the plain version to against the reference's Pallas kernel.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu_torch.frontend import masked_match as mm
from orb_slam_fusion_tpu_torch.map.convert import desc_to_torch

import torch_match_cases as cases

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (this test runs the CUDA kernel)")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernel")
    return torch.device("cuda")


@pytest.mark.parametrize("M,N", [(1, 1), (37, 5), (700, 256), (513, 1100)])
@pytest.mark.parametrize("octave", [False, True])
def test_kernel_matches_plain_on_card(cuda, M, N, octave):
    """Bit-exact against the plain version for ragged M and N (a partial
    row block, N = 1; N beyond the shared-memory budget is one of the
    adversarial cases)."""
    rng = np.random.RandomState(M + N)
    pred_uv = rng.uniform(0, 100, (M, 2)).astype(np.float32)
    kp_uv = rng.uniform(0, 100, (N, 2)).astype(np.float32)
    mp_desc = rng.randint(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(
        np.uint32)
    kp_desc = rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(
        np.uint32)
    kp_desc[: N // 2] = mp_desc[: N // 2] if M >= N // 2 else kp_desc[:N // 2]
    args = [torch.from_numpy(pred_uv).to(cuda), desc_to_torch(mp_desc, cuda),
            torch.from_numpy(rng.rand(M) > 0.1).to(cuda),
            torch.from_numpy(rng.uniform(-5, 40, M).astype(np.float32)).to(
                cuda),
            torch.from_numpy(kp_uv).to(cuda), desc_to_torch(kp_desc, cuda),
            torch.from_numpy(rng.rand(N) > 0.1).to(cuda)]
    kw = {}
    if octave:
        kw = dict(mp_octave=torch.from_numpy(
            rng.randint(-1, 8, M).astype(np.int32)).to(cuda),
            kp_octave=torch.from_numpy(
                rng.randint(0, 8, N).astype(np.int32)).to(cuda))
    before = mm.launches
    got = mm.masked_match(*args, **kw)
    assert mm.launches == before + 1
    want = mm.masked_match_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("octave", [False, True])
@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_kernel_matches_plain_on_adversarial_cases(cuda, name, octave):
    """Bit-exact against the plain version on window and cell borders,
    clusters, r = 0 / -1 / huge / infinite / NaN, NaN and infinite centres,
    keypoints at 1e9 and off the image, ties across cells, N = 1, M = 1 and
    N beyond the shared-memory budget (the chunked path)."""
    c = cases.CASES[name]()
    t = lambda k: torch.from_numpy(np.array(c[k])).to(cuda)  # noqa: E731
    args = [t("pred_uv"), desc_to_torch(c["mp_desc"], cuda), t("mp_valid"),
            t("radius"), t("kp_uv"), desc_to_torch(c["kp_desc"], cuda),
            t("kp_valid")]
    kw = (dict(mp_octave=t("mp_octave"), kp_octave=t("kp_octave"))
          if octave else {})
    before = mm.launches
    got = mm.masked_match(*args, **kw)
    assert mm.launches == before + 1
    want = mm.masked_match_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("best_idx", "best", "second")):
        assert torch.equal(g, w), (what, int((g != w).sum()))


@pytest.mark.parametrize("octave", [False, True])
@pytest.mark.parametrize("name", sorted(cases.N1200_CASES))
def test_kernel_matches_plain_at_1200_keypoints(cuda, name, octave):
    """The System session's width (1200 keypoints, the EuRoC settings'
    ORBextractor.nFeatures) and one more, bit-exact against the plain
    version."""
    c = cases.N1200_CASES[name]()
    t = lambda k: torch.from_numpy(np.array(c[k])).to(cuda)  # noqa: E731
    args = [t("pred_uv"), desc_to_torch(c["mp_desc"], cuda), t("mp_valid"),
            t("radius"), t("kp_uv"), desc_to_torch(c["kp_desc"], cuda),
            t("kp_valid")]
    kw = (dict(mp_octave=t("mp_octave"), kp_octave=t("kp_octave"))
          if octave else {})
    before = mm.launches
    got = mm.masked_match(*args, **kw)
    assert mm.launches == before + 1
    want = mm.masked_match_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("best_idx", "best", "second")):
        assert torch.equal(g, w), (what, int((g != w).sum()))
    assert int((want[1] == 0).sum()) > 0


def test_extractor_at_1200_features_on_card_matches_cpu(cuda):
    """ORB extraction at 1200 features of a remapped 480x752 EuRoC frame:
    every feature field the same bits on the card as on the CPU."""
    import chip_smoke
    from orb_slam_fusion_tpu_torch import sim
    from orb_slam_fusion_tpu_torch.frontend.extractor import (
        OrbParams, extract_features)
    from orb_slam_fusion_tpu_torch.frontend.rectify import remap_bilinear
    seq = sim.make_vio_sequence(**dict(chip_smoke.VIO_SEQ, n_frames=4))
    raw, _ = chip_smoke.system_raw_pair(seq.world, 2)
    (mL, _), _, _ = chip_smoke._euroc_rectification()
    img = remap_bilinear(torch.from_numpy(raw), torch.from_numpy(mL))
    orb = OrbParams(n_features=1200)
    want = extract_features(img, orb)
    got = extract_features(img.to(cuda), orb)
    for name in want._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    assert int(want.valid.sum()) > 1024


def test_system_frames_launch_the_kernel(cuda, tmp_path):
    """The System front door on the card: three raw pairs through
    ``track_stereo_imu`` from the EuRoC settings file, 3 masked-match
    launches on each tracked frame."""
    import chip_smoke
    from orb_slam_fusion_tpu_torch import sim
    from orb_slam_fusion_tpu_torch.system import Sensor, System
    (path, _), _ = chip_smoke.system_settings_files(str(tmp_path))
    seq = sim.make_vio_sequence(**chip_smoke.VIO_SEQ)
    sys_ = System(settings_path=path, sensor=Sensor.IMU_STEREO, verbosity=0)
    for k in range(3):
        raw = chip_smoke.system_raw_pair(seq.world, k)
        before = mm.launches
        rec = sys_.track_stereo_imu(*raw, float(seq.world.timestamps[k]),
                                    *chip_smoke._imu_of(seq, k))
        assert rec.state == ("init-done" if k == 0 else "ok")
        assert mm.launches - before == (0 if k == 0 else 3)


@pytest.mark.parametrize("N", [1024, 4097])
@pytest.mark.parametrize("M", [8192, 16384, 32768])
def test_kernel_matches_plain_at_grown_map_sizes(cuda, M, N):
    """The session's map table starts at 8192 rows and doubles when it
    fills (``grow_map``): the kernel takes every such M, on the resident
    (N <= 4096) and the chunked (N > 4096) path, bit-exact against the
    plain version with the octave gate on."""
    rng = np.random.RandomState(M + N)
    pred_uv = rng.uniform(0, 752, (M, 2)).astype(np.float32)
    kp_uv = rng.uniform(0, 752, (N, 2)).astype(np.float32)
    mp_desc = rng.randint(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(
        np.uint32)
    kp_desc = rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(
        np.uint32)
    rows = rng.choice(M, N // 2, replace=False)
    kp_desc[: N // 2] = mp_desc[rows]
    kp_uv[: N // 2] = pred_uv[rows] + rng.randn(N // 2, 2).astype(
        np.float32)
    mp_valid = rng.rand(M) > 0.3
    mp_valid[rows] = True
    mp_oct = rng.randint(0, 8, M).astype(np.int32)
    kp_oct = rng.randint(0, 8, N).astype(np.int32)
    kp_oct[: N // 2] = mp_oct[rows]
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    args = [t(pred_uv), desc_to_torch(mp_desc, cuda), t(mp_valid),
            t(rng.uniform(5, 40, M).astype(np.float32)), t(kp_uv),
            desc_to_torch(kp_desc, cuda), t(rng.rand(N) > 0.05)]
    kw = dict(mp_octave=t(mp_oct), kp_octave=t(kp_oct))
    before = mm.launches
    got = mm.masked_match(*args, **kw)
    assert mm.launches == before + 1
    want = mm.masked_match_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((want[1] == 0).sum()) > N // 4     # the planted matches


def test_session_frames_launch_the_kernel(cuda):
    """A short monocular session on the card: every tracked frame launches
    the kernel (3 calls per fused step), and each launch agrees with the
    plain version on its own inputs."""
    from orb_slam_fusion_tpu_torch import sim
    from orb_slam_fusion_tpu_torch.engine import MonoTracker, SlamConfig
    from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams

    cfg = SlamConfig(cam_params=(400.0, 400.0, 376.0, 240.0),
                     orb=OrbParams(n_features=512), max_keyframes=64,
                     max_map_points=4096, ba_window=6, loop_closing=False)
    world = sim.make_corridor_world(n_frames=12, n_points=4000, seed=3)
    tr = MonoTracker(cfg, device=cuda)
    seen, launch = [], mm.masked_match_cuda

    def record(uvr, mp_desc, kp_uvo, kp_desc, use_octave,
               fused_window=False):
        out = launch(uvr, mp_desc, kp_uvo, kp_desc, use_octave,
                     fused_window)
        seen.append((out, mm.masked_match_folded_plain(
            uvr, mp_desc, kp_uvo, kp_desc, fused_window)))
        return out

    mm.masked_match_cuda = record
    try:
        for k in range(12):
            before = len(seen)
            f = sim.render_frame(world, k, cfg.cam_params, cfg.image_size,
                                 512, pixel_noise=0.3, desc_bit_flips=3,
                                 dropout=0.08, seed=11, device=cuda)
            rec = tr.process_features(f, float(world.timestamps[k]))
            if rec.state == "ok":
                assert len(seen) - before >= 3, (k, len(seen) - before)
    finally:
        mm.masked_match_cuda = launch
    assert tr.state.name == "OK" and seen
    for got, want in seen:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


KB8 = (190.97847, 190.9733, 254.93170, 256.89742,
       0.0034823894, 0.00077133023, -0.0000034, 0.00000069)
T_C1_C2 = np.array([[1.0, 0.0, 0.0, 0.101], [0.0, 1.0, 0.0, 0.002],
                    [0.0, 0.0, 1.0, 0.001], [0.0, 0.0, 0.0, 1.0]])


@pytest.mark.parametrize("mode", ["stereo", "fisheye"])
def test_stereo_session_frames_launch_the_kernel(cuda, mode):
    """The first 10 frames of the stereo (EuRoC-like pinhole) and
    fisheye-stereo (KB8, 512x512) e2e sequences on the card: every tracked
    frame launches the kernel 3 times per fused step (twice that where the
    step falls back to the reference keyframe, as the reference's does on
    a fast start), and each launch agrees with the plain version on its
    own inputs (the fisheye frames fill cells that pinhole frames leave
    empty)."""
    from orb_slam_fusion_tpu_torch import sim
    from orb_slam_fusion_tpu_torch.engine import SlamConfig
    from orb_slam_fusion_tpu_torch.engine.stereo_tracker import (
        FisheyeStereoTracker, StereoTracker)
    from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams

    kw = dict(orb=OrbParams(n_features=512), max_keyframes=64,
              max_map_points=6144, ba_window=6, loop_closing=False)
    render = dict(pixel_noise=0.3, desc_bit_flips=3, dropout=0.08)
    if mode == "stereo":
        cfg = SlamConfig(cam_params=(400.0, 400.0, 376.0, 240.0), **kw)
        world = sim.make_corridor_world(n_frames=70, n_points=5000, seed=7)
        tr = StereoTracker(cfg, baseline=0.11, device=cuda)

        def frame(k):
            return sim.render_stereo_frame(
                world, k, cfg.cam_params, cfg.image_size, 512, 0.11,
                seed=31, device=cuda, **render)
    else:
        cfg = SlamConfig(cam_model="kannala_brandt8", cam_params=KB8,
                         image_size=(512, 512), **kw)
        world = sim.make_corridor_world(n_frames=50, n_points=6000, seed=11)
        tr = FisheyeStereoTracker(cfg, KB8, T_C1_C2, device=cuda)

        def frame(k):
            return sim.render_fisheye_stereo_frame(
                world, k, KB8, KB8, cfg.image_size, 512, T_C1_C2, seed=17,
                device=cuda, **render)
    seen, launch = [], mm.masked_match_cuda

    def record(uvr, mp_desc, kp_uvo, kp_desc, use_octave,
               fused_window=False):
        out = launch(uvr, mp_desc, kp_uvo, kp_desc, use_octave,
                     fused_window)
        seen.append((out, mm.masked_match_folded_plain(
            uvr, mp_desc, kp_uvo, kp_desc, fused_window)))
        return out

    mm.masked_match_cuda = record
    try:
        for k in range(10):
            before = len(seen)
            fL, fR = frame(k)
            rec = tr.process_stereo_features(fL, fR,
                                             float(world.timestamps[k]))
            n = len(seen) - before
            if rec.state == "ok":
                assert n in (3, 6), (k, n)
    finally:
        mm.masked_match_cuda = launch
    assert tr.state.name == "OK" and seen
    for got, want in seen:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_remap_bilinear_on_card_matches_cpu(cuda):
    """The device remap (``frontend/rectify.py``) gives its CPU twin's
    bits, taps outside the image included."""
    from orb_slam_fusion_tpu_torch.frontend.rectify import (
        remap_bilinear, remap_stereo_pair)
    rng = np.random.RandomState(0)
    h, w = 120, 160
    imgs = [torch.from_numpy((rng.rand(h, w) * 255).astype(np.float32))
            for _ in range(2)]
    maps = [torch.from_numpy(np.stack(
        [rng.uniform(-3, w + 2, (h, w)), rng.uniform(-3, h + 2, (h, w))],
        -1).astype(np.float32)) for _ in range(2)]
    want = remap_bilinear(imgs[0], maps[0])
    got = remap_bilinear(imgs[0].to(cuda), maps[0].to(cuda))
    assert torch.equal(got.cpu(), want)
    pair = remap_stereo_pair(*(t.to(cuda) for t in imgs + maps))
    for g, i, m in zip(pair, imgs, maps):
        assert torch.equal(g.cpu(), remap_bilinear(i, m))


def test_stereo_association_on_card_matches_cpu(cuda):
    """``stereo_match`` and ``subpixel_refine`` on rendered images: the
    same right-image u and masks on the card as on the CPU."""
    from orb_slam_fusion_tpu_torch import sim
    from orb_slam_fusion_tpu_torch.frontend.extractor import (
        OrbParams, extract_features)
    from orb_slam_fusion_tpu_torch.frontend.stereo import (
        stereo_match, subpixel_refine)
    cam, size = (200.0, 200.0, 188.0, 120.0), (240, 376)
    world = sim.make_corridor_world(n_frames=4, n_points=3000, seed=7)
    imgs = [sim.render_image(world, 2, cam, size),
            sim.render_image(world, 2, cam, size, pose_override=(
                sim.stereo_right_pose(world, 2, 0.11)))]
    outs = []
    for dev in (torch.device("cpu"), cuda):
        im = [torch.from_numpy(i).to(dev) for i in imgs]
        fL, fR = (extract_features(i, OrbParams(n_features=512)) for i in im)
        ur, ok = stereo_match(fL, fR)
        outs.append((ur, ok) + subpixel_refine(im[0], im[1], fL.uv, ur, ok))
    assert int(outs[0][1].sum()) > 50
    for a, b in zip(*outs):
        assert torch.equal(a, b.cpu())


def test_cuda_wrapper_rejects_cpu_tensors(cuda):
    uvr = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        mm.masked_match_cuda(uvr, torch.zeros(4, 8, dtype=torch.int32),
                             torch.zeros(2, 4),
                             torch.zeros(2, 8, dtype=torch.int32), False)


def _close_on_card(a, b, atol, what):
    assert torch.isfinite(b).all(), what
    d = float((a.double() - b.cpu().double()).abs().max())
    assert d <= atol, (what, d)


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_vi_ba_on_card_matches_cpu(cuda, stereo):
    """``visual_inertial_ba`` (cuSOLVER's Cholesky, cuBLAS's products) on
    the card against the port on the CPU, on the seeded problems the CPU
    tests hold to the JAX package: poses, velocities and biases within
    1e-4, points within 1e-3, the candidate costs within 1e-3 relative."""
    import torch_vio_problems as vp
    from orb_slam_fusion_tpu_torch.solver import vi_ba as tvi
    d = vp.seeded(3 if stereo else 4, stereo)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        state, prob, ifac, calib = vp.port_problem(d, stereo, dev)
        fixed = torch.from_numpy(d["fixed"]).to(dev)
        outs.append(tvi.visual_inertial_ba(state, prob, ifac, calib,
                                           fixed_pose=fixed,
                                           fixed_inertial=fixed, iters=10))
    (sc, pc, cc), (sg, pg, cg) = outs
    for name, a, b in (("R", sc.poses.R, sg.poses.R),
                       ("t", sc.poses.t, sg.poses.t), ("vel", sc.vel, sg.vel),
                       ("bg", sc.bg, sg.bg), ("ba", sc.ba, sg.ba)):
        _close_on_card(a, b, 1e-4, name)
    _close_on_card(pc, pg, 1e-3, "points")
    _close_on_card(cc / cc.abs().max(), cg / cc.abs().max().to(cuda), 1e-3,
                   "costs")


def test_inertial_init_and_pose_solve_on_card_match_cpu(cuda):
    """``inertial_init`` (with the scale) and ``pose_inertial_marginalized``
    on the card against the port on the CPU: scale, R_wg, biases,
    velocities, pose within 1e-4, the same inliers, the marginal's
    information within 1e-3 of its largest entry."""
    import torch_vio_problems as vp
    from orb_slam_fusion_tpu_torch import lie
    from orb_slam_fusion_tpu_torch.imu.factors import information_from_cov
    from orb_slam_fusion_tpu_torch.solver import pose_inertial_prior as pp
    from orb_slam_fusion_tpu_torch.solver import vi_ba as tvi
    d = vp.seeded(5, False, K=10, step=5, pose_noise=0.0)
    inits, solves = [], []
    for dev in (torch.device("cpu"), cuda):
        state, prob, ifac, calib = vp.port_problem(d, False, dev)
        poses = lie.SE3(state.poses.R, state.poses.t * 0.6)
        inits.append(tvi.inertial_init(poses, ifac, calib,
                                       optimize_scale=True, prior_a=1e10))
        pre = ifac.pre
        pre1 = type(pre)(*(type(x)(x.gyro[0], x.acc[0]) if hasattr(x, "gyro")
                           else x[0] for x in pre))
        prior = pp.make_initial_prior(
            lie.SE3(state.poses.R[0], state.poses.t[0]), state.vel[0],
            type(pre.bias0)(state.bg[0], state.ba[0]))
        sel = prob.kf_idx == 1
        solves.append(pp.pose_inertial_marginalized(
            prior, lie.SE3(state.poses.R[1], state.poses.t[1]),
            state.vel[1], pre1, information_from_cov(pre1), calib,
            prob.points[prob.mp_idx[sel].long()], prob.uv[sel],
            prob.inv_sigma2[sel], prob.valid[sel], prob.cam_params))
    (s0, R0, b0, v0, _), (s1, R1, b1, v1, _) = inits
    for name, a, b in (("s", s0, s1), ("R_wg", R0, R1), ("bg", b0.gyro,
                       b1.gyro), ("ba", b0.acc, b1.acc), ("vel", v0, v1)):
        _close_on_card(a, b, 1e-4, name)
    c, g = solves
    _close_on_card(c[0].R, g[0].R, 1e-4, "pose R")
    _close_on_card(c[0].t, g[0].t, 1e-4, "pose t")
    _close_on_card(c[1], g[1], 1e-4, "vel")
    assert torch.equal(c[4], g[4].cpu())
    H = c[3].H.double()
    _close_on_card(H / H.abs().max(), g[3].H / float(H.abs().max()), 1e-3,
                   "prior H")


def test_stereo_vio_frames_launch_the_kernel(cuda):
    """The first 12 frames of the stereo-inertial e2e sequence on the card
    through ``StereoVioTracker.process_stereo_imu``: every tracked frame
    launches the kernel 3 times (6 where the step falls back to the
    reference keyframe), each launch agrees with the plain version."""
    import chip_smoke
    from orb_slam_fusion_tpu_torch import sim
    from orb_slam_fusion_tpu_torch.engine import SlamConfig, StereoVioTracker
    from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
    from orb_slam_fusion_tpu_torch.imu.preintegration import make_calib

    cfg = SlamConfig(cam_params=(400.0, 400.0, 376.0, 240.0),
                     orb=OrbParams(n_features=512), max_keyframes=96,
                     max_map_points=8192, ba_window=6, loop_closing=False)
    seq = sim.make_vio_sequence(n_frames=12, seed=4, gyro_noise=1.7e-4,
                                acc_noise=2e-3, gyro_bias=0.002,
                                acc_bias=0.02)
    tr = StereoVioTracker(cfg, 0.11, make_calib(device=cuda), device=cuda)
    seen, launch = [], mm.masked_match_cuda

    def record(uvr, mp_desc, kp_uvo, kp_desc, use_octave,
               fused_window=False):
        out = launch(uvr, mp_desc, kp_uvo, kp_desc, use_octave,
                     fused_window)
        seen.append((out, mm.masked_match_folded_plain(
            uvr, mp_desc, kp_uvo, kp_desc, fused_window)))
        return out

    mm.masked_match_cuda = record
    try:
        for k in range(12):
            before = len(seen)
            fL, fR = sim.render_stereo_frame(seq.world, k, cfg.cam_params,
                                             cfg.image_size, 512, 0.11,
                                             seed=51, device=cuda)
            rec = tr.process_stereo_imu(fL, fR, float(seq.world.timestamps[k]),
                                        *chip_smoke._imu_of(seq, k))
            if rec.state == "ok":
                assert len(seen) - before in (3, 6), (k, len(seen) - before)
    finally:
        mm.masked_match_cuda = launch
    assert tr.state.name == "OK" and seen and len(tr.kf_pre) >= 2
    for got, want in seen:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _recording_launches(seen):
    """Wrap the kernel's launcher: every launch also runs the plain
    version on its own inputs."""
    launch = mm.masked_match_cuda

    def record(uvr, mp_desc, kp_uvo, kp_desc, use_octave,
               fused_window=False):
        out = launch(uvr, mp_desc, kp_uvo, kp_desc, use_octave,
                     fused_window)
        seen.append((out, mm.masked_match_folded_plain(
            uvr, mp_desc, kp_uvo, kp_desc, fused_window)))
        return out
    mm.masked_match_cuda = record
    return launch


def test_loop_session_frames_launch_the_kernel(cuda):
    """The CPU tests' loop session (loop closing on, 256 features) through
    its blackout on the card: the relocalization frame's guided retry and
    every tracked frame launch the kernel, each launch agrees with the
    plain version, and the session recovers on the CPU run's frame."""
    import chip_smoke
    from orb_slam_fusion_tpu_torch import sim

    cfg = chip_smoke._config(chip_smoke.LOOP_SESSION_CONFIG)
    world = sim.make_corridor_world(**chip_smoke.RELOC_WORLD)
    tr = MonoTracker_(cfg, cuda)
    seen = []
    launch = _recording_launches(seen)
    states = []
    try:
        for k in range(48):
            a = (chip_smoke._empty_features_numpy(cfg.orb.n_features)
                 if chip_smoke._blacked_out(
                     k, chip_smoke.LOOP_SESSION_BLACKOUTS)
                 else sim.render_frame_numpy(
                     world, k, cfg.cam_params, cfg.image_size,
                     cfg.orb.n_features, **chip_smoke.RELOC_RENDER))
            before = len(seen)
            rec = tr.process_features(sim.features_on(a, cuda),
                                      float(world.timestamps[k]))
            states.append(rec.state)
            if rec.state == "ok":
                assert len(seen) - before >= 3, (k, len(seen) - before)
    finally:
        mm.masked_match_cuda = launch
    assert states[40:45] == ["lost", "reloc-fail", "reloc-fail",
                             "reloc-fail", "ok"], states[38:46]
    for got, want in seen:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def MonoTracker_(cfg, dev):
    from orb_slam_fusion_tpu_torch.engine import MonoTracker
    return MonoTracker(cfg, device=dev)


def _loop_map(dev):
    """``chip_smoke``'s loop_correct inputs: the drifted loop map and a
    facade tracker on ``dev``."""
    import chip_smoke
    import torch_fixtures
    return torch_fixtures.load_loop_map(os.path.join(
        chip_smoke.GOLDEN_DIR, chip_smoke.LOOP_MAP_FILE), dev)


def test_loop_closer_on_card_matches_cpu(cuda):
    """The loop closer on the drifted 20-keyframe loop map: the card closes
    the loop on the keyframe the CPU does, with the same loop edge and
    funnel counters, and corrected keyframe poses within 1e-3."""
    import torch_fixtures
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = torch_fixtures.close_loop_map(*_loop_map(dev))
    cpu, card = out["cpu"], out[str(cuda)]
    assert card["closed_at"] == cpu["closed_at"] is not None
    assert card["edge"] == cpu["edge"]
    assert {k: v for k, v in card["stats"].items() if k != "best_score_max"
            } == {k: v for k, v in cpu["stats"].items()
                  if k != "best_score_max"}
    np.testing.assert_allclose(card["R"], cpu["R"], atol=1e-3)
    np.testing.assert_allclose(card["t"], cpu["t"], atol=1e-3)


def test_global_ba_pcg_on_card_matches_cpu(cuda):
    """The matrix-free PCG global BA (``ChunkedLM(pose_stride > 0)``) on
    the CPU tests' problem: the card and the CPU accept the same steps and
    end within 5e-4 (float32 CG in another summation order)."""
    import torch_fixtures
    from orb_slam_fusion_tpu_torch.solver import ba

    a = torch_fixtures.ba_problem_arrays(K=16, nf=96, M=256, spacing=0.1,
                                         n_fixed=2)
    res = {}
    for dev in ("cpu", cuda):
        prob = torch_fixtures.ba_problem(a, dev)
        lm = ba.ChunkedLM(prob, "pinhole", 2, 3, chunk=2, pose_stride=96)
        while not lm.step():
            pass
        res[str(dev)] = (lm.poses.t.cpu().numpy(), lm.points.cpu().numpy(),
                         lm.inlier.cpu().numpy())
    cpu, card = res["cpu"], res[str(cuda)]
    np.testing.assert_array_equal(card[2], cpu[2])
    np.testing.assert_allclose(card[0], cpu[0], atol=5e-4)
    np.testing.assert_allclose(card[1], cpu[1], atol=5e-4, rtol=1e-4)


def _edge_case(M, N, seed):
    """Keypoints placed on map points' window edges (r = 15), where the
    fused window rounding (fma(dv, dv, du*du)) and the separately rounded
    sum decide differently, plus random ones."""
    rng = np.random.RandomState(seed)
    uv = rng.uniform(0, 752, (M, 2)).astype(np.float32)
    kp = rng.uniform(0, 752, (N, 2)).astype(np.float32)
    rows = rng.randint(0, M, N // 2)
    dv = rng.uniform(-14, 14, N // 2).astype(np.float32)
    kp[: N // 2, 1] = uv[rows, 1] + dv
    du = np.sqrt(np.maximum(225.0 - (kp[: N // 2, 1] - uv[rows, 1]) ** 2,
                            0)).astype(np.float32)
    kp[: N // 2, 0] = uv[rows, 0] + du * np.sign(rng.randn(N // 2))
    desc = rng.randint(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    kdesc = rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    kdesc[: N // 2] = desc[rows] ^ np.uint32(1)
    return uv, desc, kp, kdesc


@pytest.mark.parametrize("M,N", [(1024, 1024), (256, 512)],
                         ids=["session_shard", "dryrun_shard"])
def test_kernel_fused_window_matches_plain_at_shard_shape(cuda, M, N):
    """The distributed tracker's calls: one shard of an 8-way split of the
    8192-point map (or the dryrun's 2048) against 1024 (512) keypoints,
    the fused window mode, bit-exact against the plain version on pairs
    at the window's edge, where the two roundings disagree."""
    uv, desc, kp, kdesc = _edge_case(M, N, M + N)
    args = [torch.from_numpy(uv).to(cuda), desc_to_torch(desc, cuda),
            torch.ones(M, dtype=torch.bool, device=cuda), 15.0,
            torch.from_numpy(kp).to(cuda), desc_to_torch(kdesc, cuda),
            torch.ones(N, dtype=torch.bool, device=cuda)]
    before = mm.launches
    got = mm.masked_match(*args, fused_window=True)
    assert mm.launches == before + 1
    want = mm.masked_match_plain(*args, fused_window=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    uvr, kp_uvo = mm._fold(args[0], args[2], 15.0, args[4], args[6], None,
                           None)
    assert not torch.equal(mm.window_mask(uvr, kp_uvo, True),
                           mm.window_mask(uvr, kp_uvo))
    plain = mm.masked_match(*args)
    assert any(not torch.equal(a, b) for a, b in zip(plain, got))


def test_distributed_frame_launches_two_kernels_per_shard(cuda):
    """A distributed frame over ``[cuda] * 8`` launches the kernel 2 x 8
    times (coarse and fine on every shard) and finds the host CPU's
    matches, inliers and counts."""
    from orb_slam_fusion_tpu_torch import cameras, lie
    from orb_slam_fusion_tpu_torch.parallel import (
        distributed_frame_update, make_slam_mesh, pad_map_for_mesh)

    rng = np.random.RandomState(3)
    M, F = 2048, 512
    pts = (rng.uniform(-8, 8, (M, 3)) + [0, 0, 10]).astype(np.float32)
    desc = rng.randint(0, 2 ** 31, (M, 8)).astype(np.uint32)
    cam = torch.tensor([400.0, 400.0, 320.0, 240.0])
    pose = lie.se3_exp(torch.tensor([0.02, -0.01, 0.03, 0.004, 0.006,
                                     -0.003]))
    uv = cameras.pinhole_project(cam, lie.se3_apply(
        pose, torch.from_numpy(pts))).numpy()
    inb = np.nonzero((uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0)
                     & (uv[:, 1] < 480))[0][:F]
    res = {}
    for dev in ("cpu", cuda):
        mesh = make_slam_mesh(devices=[dev] * 8)
        mp = pad_map_for_mesh(
            mesh, torch.from_numpy(pts).to(dev), desc_to_torch(desc, dev),
            torch.ones(M, dtype=torch.bool, device=dev),
            torch.zeros(M, dtype=torch.int32, device=dev),
            torch.zeros(M, dtype=torch.int32, device=dev))
        ident = lie.se3_identity(device=dev)
        before = mm.launches
        r = distributed_frame_update(
            *mp, ident, ident, torch.from_numpy(uv[inb]).to(dev),
            desc_to_torch(desc[inb], dev),
            torch.ones(len(inb), dtype=torch.bool, device=dev),
            torch.ones(len(inb), device=dev), cam.to(dev), mesh)
        res[str(dev)] = (r, mm.launches - before)
    (cpu, n_cpu), (card, n_card) = res["cpu"], res[str(cuda)]
    assert n_cpu == 0 and n_card == 16
    for f in ("match_idx", "inlier", "mp_visible", "mp_found", "counts"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    np.testing.assert_allclose(card.pose.t.cpu().numpy(),
                               cpu.pose.t.numpy(), atol=1e-5)


# ---- the libm kernel (csrc/libm.cu) against its twins --------------------

_LIBM_RANGES = {"sin": (-4.0, 4.0), "cos": (-4.0, 4.0), "tan": (0.0, 1.6),
                "exp": (-10.0, 10.0), "log": (0.0, 60.0),
                "atan2": (-3.0, 3.0)}


def _libm_inputs(name, n, seed):
    """n float32 inputs: half over the sites' range, a quarter of
    log-uniform magnitudes, a quarter of random bit patterns (subnormals,
    infinities and NaN payloads among them)."""
    rng = np.random.default_rng(seed)
    lo, hi = _LIBM_RANGES[name]
    q = n // 4
    mag = np.exp(rng.uniform(-85, 85, q)) * rng.choice([-1, 1], q)
    bits = rng.integers(0, 2 ** 32, q, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(np.concatenate([
        rng.uniform(lo, hi, n - 2 * q).astype(np.float32),
        mag.astype(np.float32), bits.view(np.float32)]))


@pytest.mark.parametrize("name", ["sin", "cos", "tan", "exp", "log",
                                  "atan2"])
def test_libm_kernel_matches_twin_on_card(cuda, name):
    from orb_slam_fusion_tpu_torch.utils import libm
    twin = {"sin": libm.sinf_plain, "cos": libm.cosf_plain,
            "tan": libm.tanf_plain, "exp": libm.expf_plain,
            "log": libm.logf_plain, "atan2": libm.atan2f_plain}[name]
    args = [_libm_inputs(name, 1 << 20, seed) for seed in
            range(2 if name == "atan2" else 1)]
    host = twin(*args)
    before = libm.launches
    got = getattr(libm, name)(*[a.to(cuda) for a in args])
    assert libm.launches == before + 1                 # one launch a call
    assert torch.equal(got.cpu().view(torch.int32), host.view(torch.int32))
    # the twin itself gives the host's bits on the card
    card_twin = twin(*[a.to(cuda) for a in args])
    assert torch.equal(card_twin.cpu().view(torch.int32),
                       host.view(torch.int32))


def test_libm_fma_and_contract_are_one_launch_each(cuda):
    from orb_slam_fusion_tpu_torch.utils import fused, libm
    g = torch.Generator().manual_seed(3)
    x, y, acc = (torch.randn(4096, 3, generator=g) for _ in range(3))
    before = libm.launches
    got = fused.fma_f32(x.to(cuda), y.to(cuda), acc[:1].to(cuda))
    assert libm.launches == before + 1
    assert torch.equal(got.cpu(), fused.fma_f32_plain(x, y, acc[:1]))
    # broadcast and strided operands, a zero of -0 included
    z = torch.where(torch.rand(4096, generator=g) < 0.5, -0.0, 0.0)
    got = fused.contract_f32(x.to(cuda), y.T.contiguous().T.to(cuda),
                             z.to(cuda))
    assert libm.launches == before + 2
    assert torch.equal(got.cpu().view(torch.int32),
                       fused.contract_f32_plain(x, y, z).view(torch.int32))
    got = fused.contract_f32(x[:, None].to(cuda), y[None, :7].to(cuda))
    assert torch.equal(got.cpu(), fused.contract_f32_plain(x[:, None],
                                                           y[None, :7]))


def test_libm_under_jacfwd_on_card_matches_cpu(cuda):
    from torch.func import jacfwd

    from orb_slam_fusion_tpu_torch import lie
    g = torch.Generator().manual_seed(4)
    xi = torch.randn(5, 7, generator=g) * 0.5

    def f(x):
        S = lie.sim3_exp(x)
        return torch.cat([S.s[..., None], S.t, lie.sim3_log(S)], -1)
    host = jacfwd(f)(xi)
    card = jacfwd(f)(xi.to(cuda)).cpu()
    torch.testing.assert_close(card, host, rtol=1e-5, atol=1e-6)


def test_kb8_rays_on_card_are_the_hosts(cuda):
    from orb_slam_fusion_tpu_torch import cameras
    rng = np.random.default_rng(2)
    uv = torch.from_numpy(rng.uniform(0, 512, (4000, 2)).astype(np.float32))
    # test_torch_cameras_kb8.py's camera
    cam = torch.tensor([190.97847, 190.9733, 254.93170, 256.89742,
                        0.0034823894, 0.00077133023, -0.0000034, 0.00000069],
                       dtype=torch.float32)
    host = cameras.kb8_unproject(cam, uv)
    card = cameras.kb8_unproject(cam.to(cuda), uv.to(cuda)).cpu()
    assert torch.equal(card.view(torch.int32), host.view(torch.int32))


def test_libm_octave_pow_on_card_is_the_references(cuda):
    from orb_slam_fusion_tpu_torch.utils import libm
    k = torch.cat([torch.arange(-16, 17, dtype=torch.float32),
                   torch.tensor([0.5, -17.0, 17.0, float("nan")])])
    before = libm.launches
    got = libm.octave_pow(k.to(cuda)).cpu()
    assert libm.launches == before + 1
    want = libm.octave_pow_plain(k)
    assert torch.equal(got[:33].view(torch.int32), want[:33].view(
        torch.int32))
    assert torch.isnan(got[33:]).all()
