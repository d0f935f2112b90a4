"""PyTorch port parity: the keyframe-inclusive per-frame slice as a whole.

The bench's loop at a small size: every frame runs ORB extraction and the
fused tracking step, every 2nd frame also the mapping step and a windowed
local BA. Both packages start from the same seeded world: the bench world,
with one map point planted on each feature of the image (so tracking finds
real matches), seen also by the last three keyframes (so BA constrains
each one from several viewpoints), and noise on the map points and the
keyframe observations (so the solves have residuals). They see the same
image every frame, as the bench does, and each package runs on its own
extracted features. Held: per-frame counts, keyframe stats and BA edge
counts exact; poses atol 1e-4 until the first local BA and 5e-3 after it;
the first BA candidate cost rtol 1e-3.

Later LM candidates are not compared. Landmarks seen by one keyframe of
the window make the reduced camera system nearly singular at small
damping, and float32 rounding then decides whether a candidate step is
usable: both packages reject such candidates (the reference even emits
NaN candidates, recorded as cost 0), but not always the same ones. The
accepted map then agrees only to the float32 resolution of those
landmarks (~1e-3 m here; test_torch_mapping.py measures the same effect
against a float64 run), so the poses tracked against it do too.

Past the first local BA (frames 2-3) the free-running reference does not
keep its own results across library kernels (ROADMAP C13): over
OpenBLAS's Haswell, SkylakeX and Cooperlake cores and XLA:CPU's AVX-512,
AVX2 and AVX code, its frame-2/3 counts, mapping stats and BA edge counts
spread by 2, its poses by 4.3e-3 and the frame-3 first LM candidate over
151.229-155.175 (2.61%). So there both packages run in the pinned library
regime (``torch_regime.PINNED``), the free-running counts, stats and edges
are held within 2 and that candidate within 2.61% of the reference's
(poses stay at 5e-3), and the exact checks move to carried state: from
the reference's map and pose after frame 1, the port steps frames 2-3 with
counts, stats and edge counts exact, poses atol 1e-4 and the first
candidate rtol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import torch

import test_torch_helpers as h
from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.engine.mapping import mapping_step as jmap
from orb_slam_fusion_tpu.engine.step import fused_frame_update as jtrack
from orb_slam_fusion_tpu.frontend import extractor as je
from orb_slam_fusion_tpu.solver.local_ba import local_ba_step as jlba
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch import synth
from orb_slam_fusion_tpu_torch.engine.mapping import mapping_step as tmap
from orb_slam_fusion_tpu_torch.engine.step import fused_frame_update as ttrack
from orb_slam_fusion_tpu_torch.frontend import extractor as te
from orb_slam_fusion_tpu_torch.map import convert
from orb_slam_fusion_tpu_torch.solver.local_ba import local_ba_step as tlba
from torch_regime import pinned

torch.set_num_threads(1)

M, F, K0, LEVELS, BA_W, FRAMES, KF_EVERY = 768, 192, 6, 4, 4, 4, 2
CAM = (150.0, 150.0, 80.0, 60.0)
CARRY_AFTER = KF_EVERY - 1      # the frame of the first local BA
# the reference's own spread past it across library kernels (module doc)
FREE_COUNTS, FREE_COST_RTOL = 2, 0.0261


def _world():
    rng = np.random.RandomState(11)
    img = synth.textured_image(rng, h.H_SMALL, h.W_SMALL, n_rect=20)
    m = synth.build_world(rng, M, K0, F, h.H_SMALL, h.W_SMALL, cam=CAM,
                          max_kf=16, device="cpu")
    fj = je.extract_features(jnp.asarray(img),
                             je.OrbParams(n_features=F, num_levels=LEVELS))
    ft = convert.features_from_numpy(h.jax_features_to_numpy(fj), "cpu")
    m = synth.plant_features(m, ft.uv, ft.desc, ft.octave, ft.valid,
                             cam=CAM, observers=range(K0 - 3, K0))
    fields = convert.map_state_to_numpy(m)
    # 1 cm of position noise and 0.5 px of keyframe-observation noise:
    # the pose solves and BA see real residuals
    fields["mp_pos"] = (fields["mp_pos"] + rng.randn(M, 3).astype(np.float32)
                        * 0.01).astype(np.float32)
    fields["kf_uv"] = (fields["kf_uv"] + rng.randn(*fields["kf_uv"].shape)
                       * 0.5).astype(np.float32)
    return img, fields


def _run_jax(img, fields):
    params = je.OrbParams(n_features=F, num_levels=LEVELS)
    inv_s2 = je.inv_scale_sigma2(params)
    cam = jnp.asarray(CAM, jnp.float32)
    m = h.jax_map(fields)
    pose = jlie.se3_identity()
    log = []
    for i in range(FRAMES):
        f = je.extract_features(jnp.asarray(img), params)
        u = jtrack(m.mp_pos, m.mp_desc, m.mp_valid, m.mp_visible,
                   m.mp_found, pose, pose, f.uv, f.desc, f.valid, f.octave,
                   inv_s2, cam, mp_normal=m.mp_normal,
                   mp_min_dist=m.mp_min_dist, mp_max_dist=m.mp_max_dist,
                   img_h=h.H_SMALL, img_w=h.W_SMALL, num_levels=LEVELS)
        m = m._replace(mp_visible=u.mp_visible, mp_found=u.mp_found)
        pose = u.pose
        entry = dict(counts=np.asarray(u.counts), t=np.asarray(pose.t),
                     R=np.asarray(pose.R))
        if i % KF_EVERY == KF_EVERY - 1:
            prev = jnp.stack([m.n_kf - 1, m.n_kf - 2, m.n_kf - 3])
            r = jmap(m, pose, 0.0, f.uv, f.desc, f.octave, f.valid, u.obs,
                     prev.astype(jnp.int32), cam, img_h=h.H_SMALL,
                     img_w=h.W_SMALL, num_levels=LEVELS)
            window = r.map.n_kf - BA_W + jnp.arange(BA_W, dtype=jnp.int32)
            m, costs, n_edges = jlba(r.map, window, jnp.arange(BA_W) < 2,
                                     inv_s2, cam)
            entry.update(stats=np.asarray(r.stats), costs=np.asarray(costs),
                         edges=int(n_edges), map=h.jax_map_to_numpy(m))
        log.append(entry)
    return log


def _run_port(img, fields, start=0, pose=None):
    """The port's loop from frame ``start`` on, from the map ``fields`` and
    ``pose`` (R, t) after frame ``start - 1`` (identity at frame 0)."""
    params = te.OrbParams(n_features=F, num_levels=LEVELS)
    inv_s2 = te.inv_scale_sigma2(params, device="cpu")
    cam = torch.tensor(CAM, dtype=torch.float32)
    m = convert.map_state_from_numpy(fields, "cpu")
    pose = (tlie.se3_identity(device="cpu") if pose is None
            else h.tse3(*pose))
    log = []
    for i in range(start, FRAMES):
        f = te.extract_features(torch.from_numpy(img), params)
        u = ttrack(m.mp_pos, m.mp_desc, m.mp_valid, m.mp_visible,
                   m.mp_found, pose, pose, f.uv, f.desc, f.valid, f.octave,
                   inv_s2, cam, mp_normal=m.mp_normal,
                   mp_min_dist=m.mp_min_dist, mp_max_dist=m.mp_max_dist,
                   img_h=h.H_SMALL, img_w=h.W_SMALL, num_levels=LEVELS)
        pose = u.pose
        entry = dict(counts=u.counts.numpy(), t=pose.t.numpy(),
                     R=pose.R.numpy())
        if i % KF_EVERY == KF_EVERY - 1:
            prev = torch.stack([m.n_kf - 1, m.n_kf - 2, m.n_kf - 3])
            r = tmap(m, pose, 0.0, f.uv, f.desc, f.octave, f.valid, u.obs,
                     prev.to(torch.int32), cam, img_h=h.H_SMALL,
                     img_w=h.W_SMALL, num_levels=LEVELS)
            window = r.map.n_kf - BA_W + torch.arange(BA_W,
                                                      dtype=torch.int32)
            m, costs, n_edges = tlba(r.map, window, torch.arange(BA_W) < 2,
                                     inv_s2, cam)
            entry.update(stats=r.stats.numpy(), costs=costs.numpy(),
                         edges=int(n_edges))
        log.append(entry)
    return log


def _same_frame(i, a, b, tol):
    np.testing.assert_array_equal(a["counts"], b["counts"],
                                  err_msg=f"frame {i}")
    np.testing.assert_allclose(a["t"], b["t"], atol=tol)
    np.testing.assert_allclose(a["R"], b["R"], atol=tol)
    if "stats" in a:
        np.testing.assert_array_equal(a["stats"], b["stats"])
        assert a["edges"] == b["edges"] > 0
        # the first LM candidate; later ones are not compared (module doc)
        np.testing.assert_allclose(a["costs"][0], b["costs"][0], rtol=1e-3)
        assert np.isfinite(b["costs"]).all()


@pinned
def test_slice_per_frame_parity():
    img, fields = _world()
    lj, lt = _run_jax(img, fields), _run_port(img, fields)
    for i, (a, b) in enumerate(zip(lj, lt)):
        if i <= CARRY_AFTER:
            _same_frame(i, a, b, 1e-4)
            continue
        # free-running past the first local BA: within the reference's own
        # spread (module doc)
        assert (np.abs(a["counts"] - b["counts"]) <= FREE_COUNTS).all(), (
            i, a["counts"], b["counts"])
        np.testing.assert_allclose(a["t"], b["t"], atol=5e-3)
        np.testing.assert_allclose(a["R"], b["R"], atol=5e-3)
        if "stats" in a:
            assert (np.abs(a["stats"] - b["stats"]) <= FREE_COUNTS).all()
            assert abs(a["edges"] - b["edges"]) <= FREE_COUNTS
            assert b["edges"] > 0
            np.testing.assert_allclose(b["costs"][0], a["costs"][0],
                                       rtol=FREE_COST_RTOL)
            assert np.isfinite(b["costs"]).all()
    assert all(e["counts"][1] > 50 for e in lt)      # real tracking
    # carried state: the port from the reference's map and pose after the
    # first local BA steps the next frames exactly as the reference does
    c = lj[CARRY_AFTER]
    lc = _run_port(img, c["map"], start=CARRY_AFTER + 1,
                   pose=(c["R"], c["t"]))
    for i, (a, b) in enumerate(zip(lj[CARRY_AFTER + 1:], lc),
                               CARRY_AFTER + 1):
        _same_frame(i, a, b, 1e-4)
