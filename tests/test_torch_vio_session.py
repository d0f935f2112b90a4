"""PyTorch port parity: the stereo-inertial session (``StereoVioTracker``)
from carried reference state.

The reference's ``StereoVioTracker`` runs the stereo-inertial e2e
sequence at 10 fps (``make_vio_sequence(fps=10, seed=4)``, 480x752, 512
features, 8192 map points, ``ba_window`` 6, baseline 0.11 m, features
rendered as ``tests/test_stereo_vio_e2e.py`` renders them), so VIBA1
(t > 5 s) comes within 60 frames. Its state just before four frames (a
keyframe before IMU init, the IMU-init keyframe, a plain frame after init,
the VIBA1 keyframe) is loaded into the port's tracker, and both step that
frame (``torch_vio_cases.step_both``): the frame record, counts, IMU stage,
integer map tables and the right-image u table exact; pose, velocity,
bias and keyframe positions within 1e-4.
"""

import jax.numpy as jnp
import pytest

import torch_vio_cases as cases
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.engine.vio_tracker import StereoVioTracker as JVio
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu.imu.preintegration import make_calib as j_calib
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import SlamConfig, StereoVioTracker
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.imu.preintegration import make_calib

THREADS = 2
KW = dict(cam_params=(400.0, 400.0, 376.0, 240.0), image_size=(480, 752),
          max_keyframes=96, max_map_points=8192, ba_window=6,
          loop_closing=False)
SEQ = dict(n_frames=56, fps=8.0, seed=4, gyro_noise=1.7e-4, acc_noise=2e-3,
           gyro_bias=0.002, acc_bias=0.02)
BASELINE = 0.11


@pytest.fixture(scope="module")
def run():
    jseq = jsim.make_vio_sequence(**SEQ)
    tseq = tsim.make_vio_sequence(**SEQ)
    cam = jnp.asarray(KW["cam_params"])

    def step_ref(tr, k):
        fL, fR = jsim.render_stereo_frame(jseq.world, k, cam,
                                          KW["image_size"], 512, BASELINE,
                                          seed=51)
        return tr.process_stereo_imu(fL, fR, float(jseq.world.timestamps[k]),
                                     *cases.imu_of(jseq, k))

    def step_port(tr, k):
        fL, fR = tsim.render_stereo_frame(tseq.world, k, KW["cam_params"],
                                          KW["image_size"], 512, BASELINE,
                                          seed=51, device="cpu")
        return tr.process_stereo_imu(fL, fR, float(tseq.world.timestamps[k]),
                                     *cases.imu_of(tseq, k))

    jt = JVio(JConfig(orb=JOrb(n_features=512), **KW), BASELINE, j_calib())
    found = cases.checkpoints(jt, step_ref, SEQ["n_frames"])
    return found, step_ref, step_port


@pytest.mark.parametrize("label", cases.LABELS)
def test_stereo_vio_step_from_carried_state(run, label):
    found, step_ref, step_port = run
    assert label in found, sorted(found)
    k, snap = found[label]

    def go():
        port = StereoVioTracker(SlamConfig(orb=OrbParams(n_features=512),
                                           **KW), BASELINE,
                                make_calib(device="cpu"), device="cpu")
        cases.step_both(snap, port, k, step_ref, step_port)

    cases.with_threads(THREADS, go)
