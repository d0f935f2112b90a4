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


LOOP_GOLDENS = {
    "atlas_session_480x752.json": dict(
        config={}, world=chip_smoke.ATLAS_WORLD,
        render=chip_smoke.ATLAS_RENDER, blackouts=chip_smoke.ATLAS_BLACKOUTS,
        grace=chip_smoke.ATLAS_GRACE),
    "reloc_session_480x752.json": dict(
        config={}, world=chip_smoke.RELOC_WORLD,
        render=chip_smoke.RELOC_RENDER, blackouts=chip_smoke.RELOC_BLACKOUTS,
        grace=None),
    "loop_session_480x752.json": dict(
        config=chip_smoke.LOOP_SESSION_CONFIG, world=chip_smoke.RELOC_WORLD,
        render=chip_smoke.RELOC_RENDER,
        blackouts=chip_smoke.LOOP_SESSION_BLACKOUTS, grace=None),
}


@pytest.mark.parametrize("name", sorted(LOOP_GOLDENS))
def test_loop_goldens_match_chip_smoke(name):
    """The monocular loop-closing goldens carry ``chip_smoke.py``'s
    settings, record the events their phases gate on, and the port's sim
    regenerates their inputs (a blacked-out frame included)."""
    g = _load(name)
    want = LOOP_GOLDENS[name]
    assert g["config"] == json.loads(json.dumps(want["config"]))
    assert g["world"] == want["world"] and g["render"] == want["render"]
    assert g["blackouts"] == [list(b) for b in want["blackouts"]]
    assert g["grace"] == want["grace"]
    cfg = chip_smoke._config(g["config"])
    world = sim.make_corridor_world(**g["world"])
    make = chip_smoke._mono_loop_make(world, cfg, g["render"],
                                      [tuple(b) for b in g["blackouts"]],
                                      "cpu")
    for k in (0, g["blackouts"][0][0], len(g["frames"]) - 1):
        assert make(k)[2] == g["frames"][k]["inputs_sha256"], k
    first, merge = chip_smoke._loop_events(g["frames"])
    if name.startswith("atlas"):
        assert (first, merge) == (63, 73) and g["archived"] == 0
    else:
        assert first is None and merge is None


def test_stereo_vio_atlas_golden_matches_chip_smoke():
    g = _load("stereo_vio_atlas_session_480x752.json")
    assert g["config"] == {} and g["seq"] == chip_smoke.VIO_ATLAS_SEQ
    assert g["gt"] == chip_smoke.VIO_ATLAS_GT
    assert g["render"] == chip_smoke.VIO_ATLAS_RENDER
    assert g["blackouts"] == [list(b) for b in chip_smoke.VIO_ATLAS_BLACKOUTS]
    T, fps = g["gt"]["n_frames"], g["gt"]["fps"]
    seq = sim.vio_from_gt_trajectory(*chip_smoke._circle_gt(T, fps),
                                     **g["seq"])
    cfg = chip_smoke._config(g["config"])
    nf = cfg.orb.n_features
    for k in (0, 58, T - 1):
        if chip_smoke._blacked_out(k, chip_smoke.VIO_ATLAS_BLACKOUTS):
            pair = (chip_smoke._empty_features_numpy(nf),) * 2
        else:
            pair = sim.render_stereo_frame_numpy(
                seq.world, k, cfg.cam_params, cfg.image_size, nf,
                g["baseline"], **g["render"])
        assert (chip_smoke._feats_sha(*pair)
                + chip_smoke._sha(*chip_smoke._imu_of(seq, k))
                == g["frames"][k]["inputs_sha256"]), k
    assert chip_smoke._loop_events(g["frames"]) == (63, 72)
    assert g["inertial_tables"]["n"] == [g["n_kf"]] * 5
    # the carried loop closures are the ones this run closes on those
    # frames, from its settings
    from test_torch_helpers import load_pickle
    snap = load_pickle("vio_loop_closures.pkl.gz")
    assert snap["config"] == g["config"]
    for c in snap["closures"]:
        k = c["frame"]
        assert g["frames"][k]["closed"] == c["closed"] == (
            g["frames"][k - 1]["closed"] + 1), k
        assert c["kf"] == g["frames"][k]["n_kf"] - 1, k


def test_loop_map_snapshot_is_the_reference_build(tmp_path, monkeypatch):
    """``loop_map_20kf.npz`` holds ``test_loop_closing_e2e.py``'s drifted
    map as the JAX package builds it today, ``loop_closer_steps.pkl.gz``
    that test's aliased corridor and the tree vocabulary the JAX package
    trains on the drifted map, and the snapshots this slice adds stay
    small (8 MB in all)."""
    import test_loop_closing_e2e as e2e
    from orb_slam_fusion_tpu.place.tree_vocabulary import (
        save_tree_binary, train_vocabulary)
    from test_torch_helpers import jax_map_to_numpy, load_pickle

    def same_map(m, fields):
        for k, v in jax_map_to_numpy(m).items():
            for a, b in zip(*((fields[k], v) if k == "kf_pose"
                              else ((fields[k],), (v,)))):
                np.testing.assert_array_equal(a, b, err_msg=k)

    m, gt, _, _ = e2e.build_drifted_loop_map()
    z = np.load(GOLDENS / chip_smoke.LOOP_MAP_FILE)
    fields = {k[4:]: z[k] for k in z.files if k.startswith("map.")}
    fields["kf_pose"] = (fields.pop("kf_pose.R"), fields.pop("kf_pose.t"))
    same_map(m, fields)
    assert int(z["closed_at"]) == 18
    rec = load_pickle("loop_closer_steps.pkl.gz")
    K = int(m.n_kf)
    path = tmp_path / "voc.bin"
    save_tree_binary(str(path), train_vocabulary(
        np.asarray(m.kf_desc[:K]).reshape(-1, 8)[:2000], k=8, levels=3,
        seed=1), levels=3)
    assert path.read_bytes() == rec["tree_vocab_bin"]
    captured = {}
    monkeypatch.setattr(e2e, "drive_loop_closer",
                        lambda c, t, m, K: captured.update(m=m))
    e2e.test_aliased_single_hit_rejected()
    same_map(captured["m"], rec["aliased_map"])
    assert [s["fired"] for s in rec["flat"]["steps"]] == [
        False, False, False, True, False]
    assert not any(s["fired"] for s in rec["aliased"]["steps"])
    new = ["atlas_merge_step.pkl.gz", "reloc_step.pkl.gz",
           "vio_merge_step.pkl.gz", "vio_loop_closures.pkl.gz",
           "loop_closer_steps.pkl.gz", chip_smoke.LOOP_MAP_FILE,
           "atlas_session_480x752.json", "reloc_session_480x752.json",
           "loop_session_480x752.json",
           "stereo_vio_atlas_session_480x752.json"]
    assert sum((GOLDENS / n).stat().st_size for n in new) <= 8e6


def test_system_golden_matches_chip_smoke():
    """The System session's golden carries ``chip_smoke.py``'s settings
    and stopping rule (5 frames after its IMU init, at most 80), its
    records are complete, and the port regenerates its inputs (the raw
    pair rendered at the EuRoC intrinsics, the IMU window read back from
    the mav0 tree) on a sample of frames."""
    from orb_slam_fusion_tpu_torch.io import EurocSequence
    g = _load("system_session_480x752.json")
    assert g["seq"] == chip_smoke.VIO_SEQ and g["baseline"] == \
        chip_smoke.STEREO_BASELINE
    assert (g["max_frames"], g["after_init"], g["no_init_frames"]) == (
        chip_smoke.SYSTEM_MAX_FRAMES, chip_smoke.SYSTEM_AFTER_INIT,
        chip_smoke.SYSTEM_NO_INIT_FRAMES)
    n = len(g["frames"])
    init = g["imu_init_frame"]
    assert n == (init + chip_smoke.SYSTEM_AFTER_INIT + 1 if init is not None
                 else chip_smoke.SYSTEM_NO_INIT_FRAMES)
    keys = {"state", "tracked", "n_kf", "n_mp", "inputs_sha256",
            "imu_initialized", "imu_stage", "bias"}
    assert all(set(f) == keys for f in g["frames"])
    assert chip_smoke.SYSTEM_EXACT_FRAMES <= n
    assert g["reloc"]["before"] == "LOST" and "frame" in g["reloc"]
    loc = g["localization"]
    assert loc["n_kf_before"] == loc["n_kf_after"]
    seq = sim.make_vio_sequence(**g["seq"])
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        chip_smoke.write_mav0(d, seq, n)
        frames = list(EurocSequence(d).frames())
    for k in (0, 1, n - 1):
        raw = chip_smoke.system_raw_pair(seq.world, k)
        fr = frames[k]
        assert chip_smoke._sha(*raw) + chip_smoke._sha(
            fr.imu_acc, fr.imu_gyro, fr.imu_t) == g["frames"][k][
                "inputs_sha256"], k


def test_system_mono_snapshot_is_complete():
    """tests/test_torch_system.py's JAX snapshot: the session spec, the
    records, the five trajectory files and the viewer page, and the
    atlas beside it."""
    g = _load(mk.SYSTEM_MONO_FILE)
    for k in ("config", "world", "render_seed", "localization_from"):
        assert g[k] == json.loads(json.dumps(mk.SYSTEM_MONO[k])), k
    assert len(g["frames"]) == mk.SYSTEM_MONO["frames"]
    assert set(g["files"]) == {
        "trajectory_tum", "trajectory_euroc", "trajectory_kitti",
        "keyframe_trajectory_tum", "keyframe_trajectory_euroc",
        "viewer_html", "debug_first_line"}
    z = np.load(GOLDENS / mk.SYSTEM_MONO_ATLAS)
    assert int(z["n_kf"]) == g["n_kf"] and "vocab_md5" in z.files


@pytest.mark.parametrize("name,config", [
    ("mesh_session_480x752.json", chip_smoke.MESH_SESSION_CONFIG),
    ("mesh_engine_session.json", chip_smoke.MESH_ENGINE_CONFIG)])
def test_mesh_goldens_match_chip_smoke(name, config):
    """The meshed sessions' goldens carry ``chip_smoke.py``'s settings
    (``test_mesh_engine.py``'s corridor and render; 8 shards), their
    records are complete, and the port regenerates their inputs."""
    g = _load(name)
    assert g["config"] == json.loads(json.dumps(config))
    assert g["config"]["mesh_devices"] == chip_smoke.MESH_SHARDS
    assert g["world"] == chip_smoke.MESH_WORLD == mk.MESH_WORLD
    assert g["render"] == chip_smoke.MESH_RENDER
    assert len(g["frames"]) == g["world"]["n_frames"]
    assert g["tracked"] > 45 and g["ate_m"] < 0.10
    cfg = chip_smoke._config(g["config"])
    world = sim.make_corridor_world(**g["world"])
    for k in (0, 31, g["world"]["n_frames"] - 1):
        a = sim.render_frame_numpy(world, k, cfg.cam_params, cfg.image_size,
                                   cfg.orb.n_features, **g["render"])
        assert chip_smoke._sha(*(a[n] for n in chip_smoke.FEATURE_FIELDS)) \
            == g["frames"][k]["inputs_sha256"], k


def test_mesh_snapshots_are_small_and_complete():
    """``mesh_dryrun.npz`` holds every input and result of the four
    dryrun cases at ``__graft_entry__.dryrun_multichip``'s shapes, and
    ``mesh_gba_20kf.npz`` the meshed closer's results on the loop map; the
    two stay under 1 MB."""
    z = np.load(GOLDENS / chip_smoke.MESH_DRYRUN_FILE)
    assert z["ba.points"].shape == (8192, 3) and z["ba.R"].shape[0] == 64
    assert z["ba.kf_idx"].shape == (8192 * 6,) and int(z["ba.iters"]) == 3
    assert z["pg.s"].shape == (64,) and int(z["pg.iters"]) == 10
    assert z["vi.R"].shape[0] == 12 and z["vi.points"].shape == (1024, 3)
    assert z["tr.mp_pos"].shape == (2048, 3) and z["tr.kp_uv"].shape[0] == 512
    c = z["ba.out_costs"]
    assert c[-1] < c[0] and z["tr.out_counts"].tolist() == [512, 512]
    assert z["pg.out_costs"][-1] < 0.1 * z["pg.out_costs"][0]
    for k in z.files:
        if z[k].dtype.kind == "f":
            assert np.isfinite(z[k]).all(), k
    m = np.load(GOLDENS / "mesh_gba_20kf.npz")
    assert int(m["closed_at"]) == 18 and np.isfinite(m["final_t"]).all()
    size = sum((GOLDENS / n).stat().st_size for n in (
        chip_smoke.MESH_DRYRUN_FILE, "mesh_gba_20kf.npz"))
    assert size < 1e6
