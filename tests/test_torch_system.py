"""The port's ``System`` facade against the JAX package's.

The cases of ``tests/test_system.py``, each against the JAX package where
it gives a value:

* a 16-frame monocular feature session through ``track_monocular_features``
  (256 features, loop closing on; the last 4 frames in localization mode)
  whose per-frame records (state, inliers, keyframes, map points) equal the
  JAX ``System``'s and whose poses agree within 1e-4, with the five
  trajectory files (same lines, values within 1e-4, nanosecond stamps
  exact). The JAX run is the committed snapshot
  ``tests/torch_goldens/system_mono_session.json`` (with its atlas,
  ``system_mono_atlas.npz``; ``tests/make_torch_goldens.py``), so the test
  runs the port alone;
* the interactive viewer: the port's page for the JAX session's map (loaded
  from its atlas) is the JAX page, byte for byte, embedded JSON included;
* the crash dump and the log levels (the JAX package's text), the map
  drawing (the JAX package's PNG bytes for the same map), the state
  accessors, the timing and debug dumps;
* ``_rectify`` bit-exact, ``_preprocess``'s colour conversion bit-exact on
  random RGB and BGR images, and its 480x752 frame resizes to six
  Camera.newWidth/newHeight sizes bit-exact (ROADMAP C3);
* autosave and autoload, across the packages both ways, and a
  relocalization into the JAX session's restored map;
* ``track_stereo`` on a Kannala-Brandt rig raises ``TypeError`` in both
  packages (ROADMAP A11).

Tolerance: exact, except poses and trajectory values (1e-4).
"""

import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam_fusion_tpu.config import load_settings as jload
from orb_slam_fusion_tpu.system import Sensor as JSensor
from orb_slam_fusion_tpu.system import System as JSystem
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.config import load_settings as tload
from orb_slam_fusion_tpu_torch.engine.tracker import TrackState
from orb_slam_fusion_tpu_torch.frontend import pyramid as tpyr
from orb_slam_fusion_tpu_torch.io import load_map
from orb_slam_fusion_tpu_torch.system import Sensor, System
from orb_slam_fusion_tpu_torch.viz import export_interactive
from tests.test_settings import CAMERA2_BLOCK, EUROC_YAML, TUMVI_YAML

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "torch_goldens")
with open(os.path.join(GOLDEN_DIR, "system_mono_session.json")) as _f:
    GOLDEN = json.load(_f)
ATLAS = os.path.join(GOLDEN_DIR, "system_mono_atlas.npz")
POSE_TOL = 1e-4


def _config():
    return chip_smoke._config(GOLDEN["config"])


def _frame(world, k, cfg):
    return tsim.render_frame(world, k, cfg.cam_params, cfg.image_size,
                             cfg.orb.n_features, seed=GOLDEN["render_seed"],
                             device="cpu")


@pytest.fixture(scope="module")
def session():
    cfg = _config()
    world = tsim.make_corridor_world(**GOLDEN["world"])
    sys_ = System(sensor=Sensor.MONOCULAR, config=cfg, verbosity=0,
                  device="cpu")
    recs = []
    for k in range(len(GOLDEN["frames"])):
        if k == GOLDEN["localization_from"]:
            sys_.activate_localization_mode()
        recs.append((sys_.track_monocular_features(
            _frame(world, k, cfg), float(world.timestamps[k])),
            int(sys_.tracker.map.n_kf), int(sys_.tracker.map.n_mp)))
    sys_.deactivate_localization_mode()
    return sys_, recs, world


def test_session_records_equal_jax(session):
    sys_, recs, _ = session
    for k, ((rec, n_kf, n_mp), g) in enumerate(zip(recs, GOLDEN["frames"])):
        assert (rec.state, int(rec.tracked), n_kf, n_mp) == (
            g["state"], g["tracked"], g["n_kf"], g["n_mp"]), k
        np.testing.assert_allclose(rec.pose.R.numpy(), g["pose_R"],
                                   atol=POSE_TOL)
        np.testing.assert_allclose(rec.pose.t.numpy(), g["pose_t"],
                                   atol=POSE_TOL)
    assert sys_.tracker.state.name == GOLDEN["state_name"]


def test_localization_mode(session):
    """No keyframe or point is added in localization mode, in either
    package, and the mode restores the keyframe decision."""
    sys_, recs, _ = session
    k0 = GOLDEN["localization_from"]
    g = GOLDEN["frames"]
    assert g[k0 - 1]["n_kf"] == g[-1]["n_kf"] and g[k0 - 1]["n_mp"] == \
        g[-1]["n_mp"]
    assert recs[k0 - 1][1:] == recs[-1][1:]
    assert sys_.tracker._need_new_keyframe.__name__ != "<lambda>"


def _numbers(text):
    return [[float(v) for v in ln.split()] for ln in text.splitlines()
            if ln.strip()]


def test_trajectory_files_equal_jax(session, tmp_path):
    sys_, _, _ = session
    for name in ("trajectory_tum", "trajectory_euroc", "trajectory_kitti",
                 "keyframe_trajectory_tum", "keyframe_trajectory_euroc"):
        p = str(tmp_path / f"{name}.txt")
        getattr(sys_, "save_" + name)(p)
        with open(p) as f:
            got = f.read()
        want = GOLDEN["files"][name]
        a, b = _numbers(got), _numbers(want)
        assert len(a) == len(b) > 0, name
        for x, y in zip(a, b):
            assert len(x) == len(y)
            if "euroc" in name:
                assert x[0] == y[0], name            # nanoseconds, exact
            elif "tum" in name:
                assert x[0] == y[0], name
            np.testing.assert_allclose(x, y, atol=POSE_TOL, err_msg=name)


def test_viewer_page_equals_jax(session, tmp_path):
    m, _ = load_map(ATLAS, device="cpu")
    traj = np.asarray(GOLDEN["trajectory_tum"])
    p = str(tmp_path / "viewer.html")
    export_interactive(m, p, trajectory=traj, loop_edges=[], title=(
        f"orb_slam_fusion_tpu — {len(traj)} frames, {int(m.n_kf)} KFs"))
    with open(p) as f:
        html = f.read()
    assert html == GOLDEN["files"]["viewer_html"]
    # the port's own session: a self-contained page of the same shape
    sys_, _, _ = session
    p2 = str(tmp_path / "viewer2.html")
    sys_.save_interactive_viewer(p2)
    with open(p2) as f:
        html2 = f.read()
    assert "http://" not in html2 and "https://" not in html2
    data = json.loads(re.search(r"const D=(\{.*?\});\n", html2, re.S)
                      .group(1))
    want = json.loads(re.search(r"const D=(\{.*?\});\n", html, re.S)
                      .group(1))
    assert data.keys() == want.keys()
    assert len(data["traj"]) == len(want["traj"])
    assert len(data["kf_centers"]) == len(want["kf_centers"])
    assert data["cov"] == want["cov"]


def test_map_drawing(session, tmp_path):
    """The headless map drawing: the port's PNG of the JAX session's map
    is the JAX package's, byte for byte; ``MapDrawer`` draws the port's
    own session."""
    pytest.importorskip("matplotlib")
    from orb_slam_fusion_tpu.io.serialization import load_map as jload_map
    from orb_slam_fusion_tpu.viz import draw_map as jdraw
    from orb_slam_fusion_tpu_torch.viz import MapDrawer, draw_map
    traj = np.asarray(GOLDEN["trajectory_tum"])[:, 1:4]
    pj, pt = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    jdraw(jload_map(ATLAS)[0], pj, trajectory=traj)
    draw_map(load_map(ATLAS, device="cpu")[0], pt, trajectory=traj)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    sys_, _, _ = session
    p = str(tmp_path / "map.png")
    MapDrawer(sys_.tracker).save(p)
    assert os.path.getsize(p) > 10000


def _crash_dump(crash, d):
    """One unhandled-exception dump through ``crash``'s handler: its text
    without the header and time lines."""
    crash.install_crash_handler(d)
    crash.set_state_probe(lambda: "sensor=test state=OK frame=7")
    try:
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            hook_prev, sys.stderr = sys.stderr, open(os.devnull, "w")
            try:
                sys.excepthook(*sys.exc_info())
            finally:
                sys.stderr.close()
                sys.stderr = hook_prev
        files = [f for f in os.listdir(d) if f.endswith("-py.txt")]
        assert len(files) == 1, os.listdir(d)
        assert os.path.exists(os.path.join(d, "osf-faults.txt"))
        text = open(os.path.join(d, files[0])).read()
    finally:
        crash.uninstall_crash_handler()
    assert sys.excepthook is not crash._excepthook
    head, stamp, *rest = text.splitlines()
    assert stamp.startswith("time: ")
    return head, [ln for ln in rest if not ln.startswith("  File ")]


def test_crash_dump(tmp_path):
    """The dump names the port's package and holds the engine snapshot and
    the traceback, as the JAX package's does."""
    from orb_slam_fusion_tpu.utils import crash as jcrash
    from orb_slam_fusion_tpu_torch.utils import crash
    head, body = _crash_dump(crash, str(tmp_path / "port"))
    jhead, jbody = _crash_dump(jcrash, str(tmp_path / "jax"))
    assert head == "orb_slam_fusion_tpu_torch crash dump"
    assert jhead == "orb_slam_fusion_tpu crash dump"
    assert body == jbody
    assert "engine: sensor=test state=OK frame=7" in body
    assert body[-1] == "RuntimeError: boom"


def test_verbose_levels_match_jax(capsys):
    from orb_slam_fusion_tpu.utils.verbose import Verbose as JVerbose
    from orb_slam_fusion_tpu_torch.utils.verbose import Verbose
    for name in ("QUIET", "NORMAL", "VERBOSE", "DEBUG"):
        assert getattr(Verbose, name) == getattr(JVerbose, name)
    out = []
    for v in (Verbose, JVerbose):
        level = v._level
        try:
            v.set_level(v.VERBOSE)
            v.log("shown", v.VERBOSE)
            v.log("hidden", v.DEBUG)
        finally:
            v.set_level(level)
        out.append(capsys.readouterr().err)
    assert out[0] == out[1] == "[osf] shown\n"


def _settings_file(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.fixture(scope="module")
def stereo_systems(tmp_path_factory):
    p = _settings_file(tmp_path_factory.mktemp("st"), "euroc2.yaml",
                       EUROC_YAML + CAMERA2_BLOCK)
    return (JSystem(settings=jload(p, "stereo"), sensor=JSensor.STEREO,
                    verbosity=0),
            System(settings=tload(p, "stereo", device="cpu"),
                   sensor=Sensor.STEREO, verbosity=0, device="cpu"))


def test_rectify_bit_exact(stereo_systems):
    js, ts = stereo_systems
    rng = np.random.RandomState(0)
    imgs = [(rng.rand(480, 752) * 255).astype(np.float32) for _ in range(2)]
    imgs[1] = np.round(imgs[1])
    want = js._rectify(*(jnp.asarray(a) for a in imgs))
    got = ts._rectify(*(torch.from_numpy(a) for a in imgs))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))
    assert ts.tracker.cfg.cam_params == js.tracker.cfg.cam_params


@pytest.mark.parametrize("rgb", [1, 0])
def test_preprocess_colour_bit_exact(tmp_path, rgb):
    p = _settings_file(tmp_path, "c.yaml",
                       EUROC_YAML.replace("Camera.RGB: 1",
                                          f"Camera.RGB: {rgb}"))
    js = JSystem(settings=jload(p, "mono"), sensor=JSensor.MONOCULAR,
                 verbosity=0)
    ts = System(settings=tload(p, "mono", device="cpu"),
                sensor=Sensor.MONOCULAR, verbosity=0, device="cpu")
    rng = np.random.RandomState(rgb)
    for img in ((rng.rand(480, 752, 3) * 255).astype(np.float32),
                np.round(rng.rand(480, 752, 3) * 255).astype(np.float32),
                rng.rand(7, 9, 3).astype(np.float32)):
        want = np.asarray(js._preprocess(jnp.asarray(img)))
        got = ts._preprocess(img).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.view(np.int32))


@pytest.mark.parametrize("size", [dst for _, dst in tpyr.RESIZE_STEPS],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_preprocess_resize_bit_exact(tmp_path, size):
    """The 480x752 frame resized to a settings file's
    Camera.newWidth/newHeight: the reference's bits (ROADMAP C3)."""
    p = _settings_file(tmp_path, "r.yaml", EUROC_YAML
                       + f"Camera.newWidth: {size[1]}\n"
                       f"Camera.newHeight: {size[0]}\n")
    js = JSystem(settings=jload(p, "mono"), sensor=JSensor.MONOCULAR,
                 verbosity=0)
    ts = System(settings=tload(p, "mono", device="cpu"),
                sensor=Sensor.MONOCULAR, verbosity=0, device="cpu")
    rng = np.random.RandomState(5)
    world = tsim.make_corridor_world(n_frames=3, n_points=2000, seed=1)
    for img in ((rng.rand(480, 752, 3) * 255).astype(np.float32),
                tsim.render_image(world, 1, (458.654, 457.296, 367.215,
                                             248.375), (480, 752))):
        want = np.asarray(js._preprocess(jnp.asarray(img)))
        got = ts._preprocess(img).numpy()
        assert got.shape == size
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.view(np.int32))


def test_state_accessors(tmp_path):
    p = _settings_file(tmp_path, "cfg.yaml", EUROC_YAML)
    js = JSystem(settings=jload(p, "mono"), sensor=JSensor.MONOCULAR,
                 verbosity=0)
    ts = System(settings=tload(p, "mono", device="cpu"),
                sensor=Sensor.MONOCULAR, verbosity=0, device="cpu")
    for s in (js, ts):
        assert s.get_tracking_state().name == "NO_IMAGES"
        assert not s.is_lost()
        assert s.get_image_scale() == 1.0
        assert s.get_time_from_imu_init() == 0.0
        assert s.map_changed()          # first call: unseen revision
        assert not s.map_changed()      # unchanged since
        s.change_dataset()
        s.reset_active_map()
        assert s.get_tracking_state().name == "NOT_INITIALIZED"
        assert s.get_tracked_map_points().size == 0
    assert ts.get_tracking_state() == TrackState.NOT_INITIALIZED
    assert ts._crash_snapshot() == js._crash_snapshot()


def test_timing_and_debug_dump(session, tmp_path):
    from orb_slam_fusion_tpu_torch.utils.timing import STAGES
    sys_, _, _ = session
    p = str(tmp_path / "debug.txt")
    sys_.save_debug_data(p)
    with open(p) as f:
        assert f.readline() == GOLDEN["files"]["debug_first_line"]
    cfg = chip_smoke._config(chip_smoke.IMAGE_CONFIG)
    ts = System(sensor=Sensor.MONOCULAR, config=cfg, verbosity=0,
                device="cpu")
    ts.enable_timing()
    try:
        world = tsim.make_corridor_world(n_frames=3, n_points=2500, seed=1)
        ts.track_monocular(tsim.render_image(world, 0, cfg.cam_params,
                                             cfg.image_size), 0.0)
        p1, p2 = str(tmp_path / "timing.txt"), str(tmp_path / "debug2.txt")
        ts.save_timing_stats(p1)
        ts.save_debug_data(p2)
        assert "orb_extract" in open(p1).read()
        text = open(p2).read()
        assert "trajectory_frames=1" in text and "sensor=mono" in text
    finally:
        STAGES.disable()
        STAGES.reset()


def test_autosave_autoload_across_packages(tmp_path):
    """The JAX session's atlas restores into the port's System (with the
    vocabulary guard), which then relocalizes on a frame of the session;
    the port's autosave restores into the port and into the JAX System."""
    cfg = _config()
    ts = System(sensor=Sensor.MONOCULAR, config=cfg, verbosity=0,
                device="cpu")
    ts.load_atlas(ATLAS)
    assert int(ts.tracker.map.n_kf) == GOLDEN["n_kf"]
    assert int(ts.tracker.map.n_mp) == GOLDEN["n_mp"]
    assert ts.is_lost()
    world = tsim.make_corridor_world(**GOLDEN["world"])
    rec = ts.track_monocular_features(_frame(world, 8, cfg), 99.0)
    assert rec.state == "ok" and ts.tracker.state == TrackState.OK
    # autosave on shutdown, autoload on start (port -> port, port -> JAX)
    atlas = str(tmp_path / "session.npz")
    p = _settings_file(tmp_path, "save.yaml", EUROC_YAML
                       + f'System.SaveAtlasToFile: "{atlas}"\n')
    s1 = System(settings=tload(p, "mono", device="cpu"), config=cfg,
                sensor=Sensor.MONOCULAR, verbosity=0, device="cpu")
    s1.load_atlas(ATLAS)
    s1.shutdown()
    assert os.path.exists(atlas)
    p2 = _settings_file(tmp_path, "load.yaml", EUROC_YAML
                        + f'System.LoadAtlasFromFile: "{atlas}"\n')
    s2 = System(settings=tload(p2, "mono", device="cpu"), config=cfg,
                sensor=Sensor.MONOCULAR, verbosity=0, device="cpu")
    assert int(s2.tracker.map.n_kf) == GOLDEN["n_kf"] and s2.is_lost()
    js = JSystem(settings=jload(p2, "mono"), config=_jax_config(),
                 sensor=JSensor.MONOCULAR, verbosity=0)
    assert int(js.tracker.map.n_kf) == GOLDEN["n_kf"]
    # a missing file starts a fresh session
    p3 = _settings_file(tmp_path, "missing.yaml", EUROC_YAML
                        + 'System.LoadAtlasFromFile: "/nope/missing"\n')
    s3 = System(settings=tload(p3, "mono", device="cpu"),
                sensor=Sensor.MONOCULAR, verbosity=0, device="cpu")
    assert int(s3.tracker.map.n_kf) == 0


def _jax_config():
    from orb_slam_fusion_tpu.engine import SlamConfig
    from orb_slam_fusion_tpu.frontend.extractor import OrbParams
    c = dict(GOLDEN["config"])
    c["orb"] = OrbParams(n_features=c.pop("n_features"))
    for k in ("cam_params", "image_size"):
        c[k] = tuple(c[k])
    return SlamConfig(**c)


def test_kb8_track_stereo_raises_type_error_in_both(tmp_path):
    """The fisheye stereo tracker's inherited images entry point passes
    ``images=`` to a method that does not take it: TypeError in both
    packages (ROADMAP A11), kept as the reference has it."""
    p = _settings_file(tmp_path, "tumvi.yaml", TUMVI_YAML)
    js = JSystem(settings=jload(p, "stereo"), sensor=JSensor.STEREO,
                 verbosity=0)
    ts = System(settings=tload(p, "stereo", device="cpu"),
                sensor=Sensor.STEREO, verbosity=0, device="cpu")
    img = (np.random.RandomState(0).rand(96, 128) * 255).astype(np.float32)
    with pytest.raises(TypeError):
        js.track_stereo(jnp.asarray(img), jnp.asarray(img), 0.0)
    with pytest.raises(TypeError):
        ts.track_stereo(img, img, 0.0)
