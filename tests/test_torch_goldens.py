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


def _stereo_inputs(name, g, k):
    """The port's inputs of frame k of a stereo-family golden, as the
    arrays its hash covers."""
    c = g["config"]
    r = dict(g["render"])
    nf = r.pop("n_features")
    cam = tuple(c.get("cam_params", (458.654, 457.296, 367.215, 248.375)))
    size = tuple(c.get("image_size", (480, 752)))
    world = sim.make_corridor_world(**g["world"])
    if name.startswith("stereo"):
        pair = sim.render_stereo_frame_numpy(world, k, cam, size, nf,
                                             g["baseline"], **r)
        return [v for f in pair for v in f.values()]
    if name.startswith("fisheye_stereo"):
        pair = sim.render_fisheye_stereo_frame_numpy(
            world, k, cam, cam, size, nf, np.asarray(g["T_c1_c2"]), **r)
        return [v for f in pair for v in f.values()]
    return list(sim.render_frame_numpy(
        world, k, cam, size, nf, cam_model=c.get("cam_model", "pinhole"),
        **r).values())


STEREO_FAMILY = {
    "stereo_session_480x752.json": dict(
        world=chip_smoke.STEREO_WORLD, render=chip_smoke.STEREO_RENDER,
        config={"loop_closing": False}),
    "stereo_e2e_session_480x752.json": dict(
        world=chip_smoke.STEREO_WORLD,
        render=dict(chip_smoke.STEREO_RENDER, n_features=512),
        config=chip_smoke.E2E_CONFIG),
    "rgbd_session_480x752.json": dict(
        world=chip_smoke.RGBD_WORLD, render=chip_smoke.RGBD_RENDER,
        config=chip_smoke.E2E_CONFIG),
    "fisheye_mono_session_512x512.json": dict(
        world=chip_smoke.FISHEYE_MONO_WORLD,
        render=chip_smoke.FISHEYE_MONO_RENDER,
        config=chip_smoke.FISHEYE_CONFIG),
    "fisheye_stereo_session_512x512.json": dict(
        world=chip_smoke.FISHEYE_STEREO_WORLD,
        render=chip_smoke.FISHEYE_STEREO_RENDER,
        config=chip_smoke.FISHEYE_CONFIG),
}


@pytest.mark.parametrize("name", sorted(STEREO_FAMILY))
def test_stereo_family_golden_matches_chip_smoke(name):
    """The stereo, RGB-D and fisheye goldens carry ``chip_smoke.py``'s
    settings and the port's ``sim`` regenerates their inputs (the RGB-D
    hash also covers the per-feature depths, which the session phase
    checks on the card)."""
    g = _load(name)
    want = STEREO_FAMILY[name]
    assert g["world"] == want["world"]
    assert g["render"] == want["render"]
    assert g["config"] == json.loads(json.dumps(want["config"]))
    assert len(g["frames"]) == g["world"]["n_frames"]
    assert g["tracked"] > 0.8 * g["world"]["n_frames"]
    if name.startswith("rgbd"):
        return
    for k in (0, g["world"]["n_frames"] - 1):
        assert chip_smoke._sha(*_stereo_inputs(name, g, k)) == g["frames"][
            k]["inputs_sha256"], k


def test_fisheye_image_golden_matches_chip_smoke():
    """The KB8 image golden carries ``chip_smoke.py``'s settings and
    frame count, and the port's ``sim`` renders its 512x512 images; the
    JAX package initializes on none of those frames, which the card's
    sub-phase is held to."""
    g = _load("fisheye_image_session_512x512.json")
    assert g["config"] == json.loads(json.dumps(chip_smoke.FISHEYE_CONFIG))
    assert g["world"] == chip_smoke.FISHEYE_MONO_WORLD
    assert g["n_frames"] == len(g["frames"]) == chip_smoke.FISHEYE_IMAGE_FRAMES
    assert g["init_frame"] is None and g["tracked"] == 0
    assert all(f["state"].startswith("init-") for f in g["frames"])
    cfg = chip_smoke._config(chip_smoke.FISHEYE_CONFIG)
    world = sim.make_corridor_world(**g["world"])
    for k in (0, g["n_frames"] - 1):
        img = sim.render_image(world, k, cfg.cam_params, cfg.image_size,
                               cam_model=cfg.cam_model)
        assert chip_smoke._sha(img) == g["frames"][k]["inputs_sha256"], k


@pytest.mark.parametrize("name", ["mono_session_480x752.json",
                                  "image_session_240x376.json"]
                         + sorted(STEREO_FAMILY))
def test_golden_records_are_complete(name):
    g = _load(name)
    keys = {"state", "tracked", "n_kf", "n_mp", "inputs_sha256"}
    assert all(set(f) == keys for f in g["frames"])
    assert g["jax_version"] and g["generated_by"].endswith(
        "make_torch_goldens.py")
    assert np.isfinite(g["ate_m"])
    traj = np.asarray(g["trajectory_tum"])
    assert traj.shape == (len(g["frames"]), 8) and np.isfinite(traj).all()


INERTIAL = {
    "stereo_vio_session_480x752.json": dict(
        seq=chip_smoke.VIO_SEQ, render=chip_smoke.VIO_RENDER,
        config={"loop_closing": False}),
    "stereo_vio_e2e_session_480x752.json": dict(
        seq=chip_smoke.VIO_E2E_SEQ,
        render=dict(chip_smoke.VIO_RENDER, n_features=512),
        config=chip_smoke.VIO_E2E_CONFIG),
    "vio_staged_session_480x752.json": dict(
        seq=chip_smoke.STAGED_SEQ, render=chip_smoke.STAGED_RENDER,
        config=chip_smoke.STAGED_CONFIG),
}


@pytest.mark.parametrize("name", sorted(INERTIAL))
def test_inertial_golden_matches_chip_smoke(name):
    """The inertial goldens carry ``chip_smoke.py``'s settings; the port's
    ``sim`` regenerates their inputs (both feature sets or the one, and the
    frame's IMU samples) on the first and last frames; their records have
    the IMU stage and bias of every frame; the sessions reached the stages
    ``chip_smoke.py`` gates (IMU init in the stereo ones, all three in the
    staged one)."""
    g = _load(name)
    want = INERTIAL[name]
    assert g["seq"] == want["seq"] and g["render"] == want["render"]
    assert g["config"] == json.loads(json.dumps(want["config"]))
    assert len(g["frames"]) == g["seq"]["n_frames"]
    keys = {"state", "tracked", "n_kf", "n_mp", "inputs_sha256",
            "imu_initialized", "imu_stage", "bias"}
    assert all(set(f) == keys and len(f["bias"]) == 6 for f in g["frames"])
    stages = [f["imu_stage"] for f in g["frames"]]
    assert stages == sorted(stages)
    assert set(stages) >= ({0, 1, 2, 3} if "staged" in name else {0, 1})
    assert g["tracked"] > 0.9 * len(g["frames"])
    seq = sim.make_vio_sequence(**g["seq"])
    c = g["config"]
    cam = tuple(c.get("cam_params", (458.654, 457.296, 367.215, 248.375)))
    size = tuple(c.get("image_size", (480, 752)))
    r = dict(g["render"])
    nf = r.pop("n_features")
    for k in (0, len(g["frames"]) - 1):
        if "staged" in name:
            arrays = list(sim.render_frame_numpy(seq.world, k, cam, size, nf,
                                                 **r).values())
        else:
            pair = sim.render_stereo_frame_numpy(seq.world, k, cam, size, nf,
                                                 g["baseline"], **r)
            arrays = [v for f in pair for v in f.values()]
        digest = chip_smoke._sha(*arrays) + chip_smoke._sha(
            *chip_smoke._imu_of(seq, k))
        assert digest == g["frames"][k]["inputs_sha256"], k
    traj = np.asarray(g["trajectory_tum"])
    assert traj.shape == (len(g["frames"]), 8) and np.isfinite(traj).all()


def test_stereo_vio_solver_snapshot_is_small_and_complete():
    """The solver calls ``tests/test_torch_vi_ba.py`` replays: both
    keyframes' calls present, 5 MB at most."""
    path = GOLDENS / "stereo_vio_solver_calls.npz"
    assert path.stat().st_size <= 5 * 2 ** 20
    z = np.load(path)
    calls = sorted({".".join(k.split(".")[:3]) for k in z.files
                    if k.count(".") >= 3})
    assert [c.split(".", 1)[1] for c in calls] == [
        "0.inertial_init", "1.visual_inertial_ba", "0.visual_inertial_ba",
        "1.inertial_init", "2.visual_inertial_ba"]
    assert int(z["stage1.frame"]) < int(z["stage2.frame"])
