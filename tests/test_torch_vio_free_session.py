"""PyTorch port parity: a free-running stereo-inertial session against the
JAX package's golden run.

The port's ``StereoVioTracker`` runs the first 48 frames of the
stereo-inertial e2e sequence at that test's widths (480x752, 512
features, 96 keyframe slots, 8192 map points, ``ba_window`` 6, baseline
0.11 m), through IMU init (frame 40 in the golden) and eight inertial
frames after it. It is held to ``tests/torch_goldens/
stereo_vio_e2e_session_480x752.json`` (the reference's run of all 80
frames, written by ``tests/make_torch_goldens.py``), gated as
``chip_smoke.py``'s ``stereo_vio_session`` phase: the same input hashes
and the same state on every frame, the same tracked count, IMU init on
the golden's keyframe +-1 and in the same stage at the end, keyframes
within 3 and map points within 5% of the golden's at the last frame run,
the metric ATE under the e2e test's 0.1 m and within 20 mm of the
golden's over the same frames. The reference does not run here.
"""

import json
import pathlib

import numpy as np

import chip_smoke
import torch_vio_cases as cases
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import SlamConfig, StereoVioTracker
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.imu.preintegration import make_calib
from orb_slam_fusion_tpu_torch.io import ate_rmse

THREADS = 2
FREE_FRAMES = 48
GOLDEN = (pathlib.Path(__file__).resolve().parent / "torch_goldens"
          / "stereo_vio_e2e_session_480x752.json")


def test_free_running_stereo_vio_against_golden():
    g = json.loads(GOLDEN.read_text())
    assert g["seq"] == chip_smoke.VIO_E2E_SEQ
    assert g["render"] == dict(chip_smoke.VIO_RENDER, n_features=512)
    c = dict(g["config"])
    cfg = SlamConfig(orb=OrbParams(n_features=c.pop("n_features")),
                     cam_params=tuple(c.pop("cam_params")),
                     image_size=tuple(c.pop("image_size")), **c)
    seq = tsim.make_vio_sequence(**g["seq"])
    render = dict(g["render"])
    nf = render.pop("n_features")

    def go():
        tt = StereoVioTracker(cfg, g["baseline"], make_calib(device="cpu"),
                              device="cpu")
        rows = []
        for k in range(FREE_FRAMES):
            pair = tsim.render_stereo_frame_numpy(
                seq.world, k, cfg.cam_params, cfg.image_size, nf,
                g["baseline"], **render)
            imu = cases.imu_of(seq, k)
            digest = (chip_smoke._sha(*(v for f in pair for v in f.values()))
                      + chip_smoke._sha(*imu))
            assert digest == g["frames"][k]["inputs_sha256"], k
            rec = tt.process_stereo_imu(
                *(tsim.features_on(f, "cpu") for f in pair),
                float(seq.world.timestamps[k]), *imu)
            rows.append((rec.state, int(tt.map.n_kf), int(tt.map.n_mp),
                         int(tt._imu_stage)))
        return tt, rows

    tt, rows = cases.with_threads(THREADS, go)
    gold = g["frames"][:FREE_FRAMES]
    assert [r[0] for r in rows] == [f["state"] for f in gold]
    stages = [r[3] for r in rows]
    gstages = [f["imu_stage"] for f in gold]
    assert 1 in gstages and stages[-1] == gstages[-1]
    kf_at = rows[stages.index(1)][1]
    assert abs(kf_at - gold[gstages.index(1)]["n_kf"]) <= \
        chip_smoke.VIO_STAGE_KF_TOL
    assert abs(rows[-1][1] - gold[-1]["n_kf"]) <= chip_smoke.VIO_KF_TOL
    assert abs(rows[-1][2] - gold[-1]["n_mp"]) <= \
        chip_smoke.SESSION_MP_RTOL * gold[-1]["n_mp"]
    gt = tsim.gt_positions(seq.world)[:FREE_FRAMES]
    traj = tt.trajectory_tum()[:, 1:4]
    want = np.asarray(g["trajectory_tum"])[:FREE_FRAMES, 1:4]
    ate = ate_rmse(traj, gt, with_scale=False)
    ate_g = ate_rmse(want, gt, with_scale=False)
    assert ate < 0.1
    assert abs(ate - ate_g) < chip_smoke.VIO_ATE_TOL_M, (ate, ate_g)
