"""The golden runs ``chip_smoke.py`` holds the port's sessions to.

``tests/make_torch_goldens.py`` writes them with the JAX package on the
CPU, from ``chip_smoke.py``'s settings. These checks are cheap: the
committed files' configuration, world and render arguments are the ones
``chip_smoke.py`` drives today, and
the port's ``sim`` regenerates the golden's inputs (per-frame SHA-256 of
the feature arrays or the image) on a sample of frames.
"""

import json
import pathlib

import numpy as np
import pytest

import chip_smoke
import make_torch_goldens as mk
from orb_slam_fusion_tpu_torch import sim

GOLDENS = pathlib.Path(__file__).resolve().parent / "torch_goldens"


def _load(name):
    return json.loads((GOLDENS / name).read_text())


def test_mono_golden_matches_chip_smoke():
    g = _load("mono_session_480x752.json")
    assert g["world"] == chip_smoke.SESSION_WORLD
    assert g["render"] == chip_smoke.SESSION_RENDER
    assert g["config"] == {"loop_closing": False} == mk.MONO["config"]
    assert len(g["frames"]) == g["world"]["n_frames"]
    assert g["init_frame"] is not None and g["ate_m"] > 0
    assert g["tracked"] == sum(f["state"] in ("ok", "init-done")
                               for f in g["frames"])
    assert g["tracked"] >= 60   # else chip_smoke would need more points
    world = sim.make_corridor_world(**g["world"])
    r = dict(g["render"])
    nf = r.pop("n_features")
    for k in (0, 1, 40, 79):
        a = sim.render_frame_numpy(world, k, (458.654, 457.296, 367.215,
                                              248.375), (480, 752), nf, **r)
        assert chip_smoke._sha(*a.values()) == g["frames"][k][
            "inputs_sha256"], k


def test_image_golden_matches_chip_smoke():
    g = _load("image_session_240x376.json")
    c = dict(g["config"])
    cfg = chip_smoke._image_config()
    assert tuple(c.pop("cam_params")) == cfg.cam_params
    assert tuple(c.pop("image_size")) == cfg.image_size
    assert c.pop("n_features") == cfg.orb.n_features
    for k, v in c.items():
        assert getattr(cfg, k) == v, k
    assert g["config"] == mk.IMAGE["config"]
    assert g["world"] == chip_smoke.IMAGE_WORLD
    world = sim.world_from_trajectory(
        chip_smoke._gentle_positions(g["world"]["n_frames"]),
        n_points=g["world"]["n_points"], seed=g["world"]["seed"])
    for k in (0, 20, 49):
        img = sim.render_image(world, k, cfg.cam_params, cfg.image_size)
        assert chip_smoke._sha(img) == g["frames"][k]["inputs_sha256"], k


@pytest.mark.parametrize("name", ["mono_session_480x752.json",
                                  "image_session_240x376.json"])
def test_golden_records_are_complete(name):
    g = _load(name)
    keys = {"state", "tracked", "n_kf", "n_mp", "inputs_sha256"}
    assert all(set(f) == keys for f in g["frames"])
    assert g["jax_version"] and g["generated_by"].endswith(
        "make_torch_goldens.py")
    assert np.isfinite(g["ate_m"])
    traj = np.asarray(g["trajectory_tum"])
    assert traj.shape == (len(g["frames"]), 8) and np.isfinite(traj).all()
