"""PyTorch port parity: the monocular-inertial session (``VioTracker``)
from carried reference state.

The reference's ``VioTracker`` runs the staged-init sequence of
``tests/test_staged_imu_init.py`` (seed 4, gyro/acc bias 0.005/0.04,
480x752, 512 features, 128 keyframe slots, 6144 map points, ``ba_window``
6) at 8 fps, so the scale-estimating IMU init and VIBA1 come within 56
frames. Its state just before a keyframe before IMU init, the IMU-init
keyframe, a plain frame after init and the VIBA1 keyframe is loaded into
the port's tracker and both step that frame
(``torch_vio_cases.step_both``): the frame record, counts, IMU stage and
integer map tables exact; pose, velocity, bias and keyframe positions
within 1e-4, except on the IMU-init keyframe, where they are held to
1 cm (``MONO_INIT_ATOL``: the full VI-BA after a monocular init is flat
in float32 in both packages). The test runs in the pinned library regime
(``torch_regime.PINNED``, ROADMAP C13): the carried states come from the
reference's free-running session.
"""

import jax.numpy as jnp
import pytest

import torch_vio_cases as cases
from torch_regime import pinned
from orb_slam_fusion_tpu import sim as jsim
from orb_slam_fusion_tpu.engine import SlamConfig as JConfig
from orb_slam_fusion_tpu.engine.vio_tracker import VioTracker as JVio
from orb_slam_fusion_tpu.frontend.extractor import OrbParams as JOrb
from orb_slam_fusion_tpu.imu.preintegration import make_calib as j_calib
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import SlamConfig, VioTracker
from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
from orb_slam_fusion_tpu_torch.imu.preintegration import make_calib

THREADS = 2
KW = dict(cam_params=(400.0, 400.0, 376.0, 240.0), image_size=(480, 752),
          max_keyframes=128, max_map_points=6144, ba_window=6,
          loop_closing=False)
SEQ = dict(n_frames=56, fps=8.0, seed=4, gyro_noise=1.7e-4, acc_noise=2e-3,
           gyro_bias=0.005, acc_bias=0.04)
RENDER = dict(pixel_noise=0.3, desc_bit_flips=3, dropout=0.08, seed=21)
# On the IMU-init keyframe the full VI-BA that follows the monocular init
# (16 keyframe rows, just re-scaled) is flat in float32: its 12 candidate
# costs fall from 376.478 to 376.454, steps of 1e-3..1e-2 against the cost
# sum's rounding of ~4e-3, so which steps are accepted is rounding in
# either package. From the same inputs (within 2.5e-6) and the same
# inertial_init result (R_wg within 1.2e-7), the two packages' poses then
# part by 6.1 mm and velocities by 3.3 mm/s. Everything discrete still
# agrees exactly; the continuous state of that one step is held to 1 cm.
MONO_INIT_ATOL = 1e-2


@pytest.fixture(scope="module")
def run():
    jseq = jsim.make_vio_sequence(**SEQ)
    tseq = tsim.make_vio_sequence(**SEQ)
    cam = jnp.asarray(KW["cam_params"])

    def step_ref(tr, k):
        f = jsim.render_frame(jseq.world, k, cam, KW["image_size"], 512,
                              **RENDER)
        return tr.process_frame_imu(f, float(jseq.world.timestamps[k]),
                                    *cases.imu_of(jseq, k))

    def step_port(tr, k):
        f = tsim.render_frame(tseq.world, k, KW["cam_params"],
                              KW["image_size"], 512, device="cpu", **RENDER)
        return tr.process_frame_imu(f, float(tseq.world.timestamps[k]),
                                    *cases.imu_of(tseq, k))

    jt = JVio(JConfig(orb=JOrb(n_features=512), **KW), j_calib())
    found = cases.checkpoints(jt, step_ref, SEQ["n_frames"])
    return found, step_ref, step_port


@pinned
@pytest.mark.parametrize("label", cases.LABELS)
def test_mono_vio_step_from_carried_state(run, label):
    found, step_ref, step_port = run
    assert label in found, sorted(found)
    k, snap = found[label]

    def go():
        port = VioTracker(SlamConfig(orb=OrbParams(n_features=512), **KW),
                          make_calib(device="cpu"), device="cpu")
        cases.step_both(snap, port, k, step_ref, step_port,
                        atol=MONO_INIT_ATOL if label == "imu_init_keyframe"
                        else 1e-4)

    cases.with_threads(THREADS, go)
