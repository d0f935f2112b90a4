"""The multi-device slice as a whole on the CPU: a ``MonoTracker`` with
``mesh_devices=8`` at ``test_mesh_engine.py``'s configuration (512
features, 4,096 map points, 64 keyframe slots, ``ba_window`` 6, loop
closing on) on its corridor (60 frames, 4,000 points, seed 3; render seed
11, 0.3 px noise, 3 flipped bits, 8% dropout).

On a CPU tracker ``mesh_devices`` builds a mesh of 8 CPU shards, the
counterpart of the reference's 8 virtual devices: per-frame tracking runs
map-sharded (``distributed_frame_update``), local BA landmark-sharded and
synchronous (``distributed_bundle_adjustment``).

* The reference test's gates: tracking OK at the end, more than 45 frames
  tracked, at least 5 keyframes and 300 map points, ATE after init under
  0.10 m (with scale alignment).
* Against the JAX package's mesh engine on the same inputs
  (``torch_goldens/mesh_engine_session.json``, written by
  ``tests/make_torch_goldens.py`` on its 8 virtual devices): the same
  input hashes, and on every frame the same state, tracked count,
  keyframe and map-point counts; the ATE within 5 mm of the golden's.
* ``LoopCloser._global_ba_dist``: the closer of ``loop_map_20kf.npz``
  with a facade tracker on 8 CPU shards closes the loop on the golden's
  keyframe with its edge and runs the distributed global BA in place of
  the chunked one; the keyframe poses after it within 1e-3 m (and
  rotation entries) of the JAX closer's with a meshed tracker
  (``mesh_gba_20kf.npz``), the point table within 1e-2 m.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_helpers as h
import torch_fixtures
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.engine import MonoTracker
from orb_slam_fusion_tpu_torch.io import evaluation
from orb_slam_fusion_tpu_torch.parallel import make_slam_mesh

GOLDEN = h.GOLDENS / "mesh_engine_session.json"
FIELDS = ("uv", "response", "octave", "angle", "desc", "valid")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def run():
    g = json.loads(GOLDEN.read_text())
    assert g["config"] == json.loads(json.dumps(
        chip_smoke.MESH_ENGINE_CONFIG))
    assert g["world"] == chip_smoke.MESH_WORLD
    assert g["render"] == chip_smoke.MESH_RENDER
    cfg = chip_smoke._config(g["config"])
    world = tsim.make_corridor_world(**g["world"])
    tr = MonoTracker(cfg, device="cpu")
    rows, shas = [], []

    def step(k):
        a = tsim.render_frame_numpy(world, k, cfg.cam_params,
                                    cfg.image_size, cfg.orb.n_features,
                                    **g["render"])
        shas.append(chip_smoke._sha(*(a[n] for n in FIELDS)))
        rec = tr.process_features(tsim.features_on(a, "cpu"),
                                  float(world.timestamps[k]))
        rows.append((rec.state, int(rec.tracked), int(tr.map.n_kf),
                     int(tr.map.n_mp)))
    h.with_threads(2, lambda: [step(k) for k in range(g["world"]
                                                      ["n_frames"])])
    return g, world, tr, rows, shas


def test_mesh_engine_tracks(run):
    g, world, tr, rows, shas = run
    assert tr.mesh.shape == {"mp": 8}
    assert all(d.type == "cpu" for d in tr.mesh.devices)
    assert tr._pending_lba is None          # no background BA on a mesh
    states = [r[0] for r in rows]
    assert tr.state.name == "OK", states[-5:]
    assert sum(s in ("ok", "init-done") for s in states) > 45, states
    assert int(tr.map.n_kf) >= 5
    assert int(tr.map.n_mp) >= 300


def test_mesh_engine_ate(run):
    g, world, tr, rows, shas = run
    states = [r[0] for r in rows]
    traj = tr.trajectory_tum()
    start = states.index("init-done")
    ate = evaluation.ate_rmse(traj[start:, 1:4],
                              tsim.gt_positions(world)[start:len(traj)],
                              with_scale=True)
    assert ate < 0.10, ate
    assert abs(ate - g["ate_m"]) < 5e-3, (ate, g["ate_m"])


def test_mesh_engine_follows_reference(run):
    g, world, tr, rows, shas = run
    assert shas == [f["inputs_sha256"] for f in g["frames"]]
    want = [(f["state"], f["tracked"], f["n_kf"], f["n_mp"])
            for f in g["frames"]]
    for k, (a, b) in enumerate(zip(rows, want)):
        assert a == b, (k, a, b)


def test_global_ba_dist_matches_reference():
    z = np.load(os.path.join(chip_smoke.GOLDEN_DIR, "mesh_gba_20kf.npz"))
    tracker, closer, _ = torch_fixtures.load_loop_map(
        os.path.join(chip_smoke.GOLDEN_DIR, chip_smoke.LOOP_MAP_FILE), CPU)
    tracker.mesh = make_slam_mesh(devices=[CPU] * 8)
    out = h.with_threads(2, lambda: torch_fixtures.close_loop_map(
        tracker, closer, z))
    assert out["closed_at"] == int(z["closed_at"])
    assert out["edge"] == z["edge"].tolist()
    assert closer.pending_gba is None        # ran in place, not chunked
    want = json.loads(str(z["stats"]))
    assert sorted(want) == sorted(closer.stats)
    for key, v in want.items():         # the BoW score, a float sum: 1e-6
        assert abs(closer.stats[key] - v) <= (1e-6 if key == "best_score_max"
                                              else 0), key
    np.testing.assert_allclose(out["R"], z["final_R"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out["t"], z["final_t"], atol=1e-3, rtol=0)
    assert int(tracker.map.n_mp) == int(z["n_mp"])
    np.testing.assert_allclose(tracker.map.mp_pos.numpy(), z["final_mp_pos"],
                               atol=1e-2, rtol=0)
