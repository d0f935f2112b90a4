"""PyTorch port parity: the fisheye stereo-inertial session
(``FisheyeStereoVioTracker``).

Both packages' trackers (the TUM-VI-like Kannala-Brandt 8 rig of
``tests/test_fisheye_e2e.py``: 512x512, 512 features, 6144 map points,
``ba_window`` 6, ``make_calib()``) run the first 12 frames of the
stereo-inertial sequence (``make_vio_sequence(seed=4)``) rendered through
``render_fisheye_stereo_frame`` with the IMU samples between frames. As in
the reference, the map starts from the monocular two-view initialization,
the fisheye left/right association supplies depth, and every frame
preintegrates its IMU window. Held exactly: the frame records (state,
inliers), keyframe and map-point counts, and the keyframes' inertial
records (window lengths, timestamps); the pose within 1e-4 on every
frame, the last keyframe window's preintegration bit-exact.
"""

import jax.numpy as jnp
import numpy as np

import chip_smoke
import torch_vio_cases as cases
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.engine.vio_tracker import (
    FisheyeStereoVioTracker as JFish)
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu.imu.preintegration import make_calib as j_calib
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import (FisheyeStereoVioTracker,
                                              SlamConfig)
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.imu.preintegration import make_calib

THREADS = 2
FRAMES = 12
SEQ = dict(n_frames=FRAMES, seed=4, gyro_noise=1.7e-4, acc_noise=2e-3,
           gyro_bias=0.002, acc_bias=0.02)
RENDER = dict(pixel_noise=0.3, desc_bit_flips=3, dropout=0.08, seed=17)


def _kw():
    c = dict(chip_smoke.FISHEYE_CONFIG)
    c.pop("n_features")
    return c


def test_fisheye_stereo_vio_first_frames():
    kw = _kw()
    T12 = np.asarray(chip_smoke.T_C1_C2)
    jseq = jsim.make_vio_sequence(**SEQ)
    tseq = tsim.make_vio_sequence(**SEQ)
    jt = JFish(JConfig(orb=JOrb(n_features=512), **kw), kw["cam_params"],
               T12, j_calib())
    cam = jnp.asarray(kw["cam_params"])

    def go():
        tt = FisheyeStereoVioTracker(
            SlamConfig(orb=OrbParams(n_features=512), **kw),
            kw["cam_params"], T12, make_calib(device="cpu"), device="cpu")
        rows_j, rows_t = [], []
        for k in range(FRAMES):
            fj = jsim.render_fisheye_stereo_frame(
                jseq.world, k, cam, cam, kw["image_size"], 512, T12,
                **RENDER)
            ft = tsim.render_fisheye_stereo_frame(
                tseq.world, k, kw["cam_params"], kw["cam_params"],
                kw["image_size"], 512, T12, device="cpu", **RENDER)
            ts = float(jseq.world.timestamps[k])
            rj = jt.process_stereo_imu(*fj, ts, *cases.imu_of(jseq, k))
            rt = tt.process_stereo_imu(*ft, ts, *cases.imu_of(tseq, k))
            rows_j.append((rj.state, int(rj.tracked), int(jt.map.n_kf),
                           int(jt.map.n_mp)))
            rows_t.append((rt.state, int(rt.tracked), int(tt.map.n_kf),
                           int(tt.map.n_mp)))
            assert rows_j[-1] == rows_t[-1], (k, rows_j, rows_t)
            np.testing.assert_allclose(tt.cur_pose.t.numpy(),
                                       np.asarray(jt.cur_pose.t), atol=1e-4)
            np.testing.assert_allclose(tt.cur_pose.R.numpy(),
                                       np.asarray(jt.cur_pose.R), atol=1e-4)
        assert sum(r[0] == "ok" for r in rows_t) >= FRAMES // 2, rows_t
        assert jt.kf_time == tt.kf_time
        assert [None if r is None else len(r[2]) for r in jt.kf_raw] == \
            [None if r is None else len(r[2]) for r in tt.kf_raw]
        last = [k for k, p in enumerate(jt.kf_pre) if p is not None]
        assert last, "no keyframe carried an inertial factor"
        pj, pt = jt.kf_pre[last[-1]], tt.kf_pre[last[-1]]
        for f in ("dT", "dR", "dV", "dP", "cov", "JRg"):
            np.testing.assert_array_equal(np.asarray(getattr(pj, f)),
                                          getattr(pt, f).numpy(), err_msg=f)

    cases.with_threads(THREADS, go)
