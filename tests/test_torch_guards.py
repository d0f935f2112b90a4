"""Guards on the PyTorch port's boundaries.

* The port and chip_smoke.py import no JAX and nothing of the JAX package,
  not even lazily: a fresh interpreter with both blocked imports every
  module of the port, chip_smoke's module-level code and the test fixtures
  it loads (``tests/torch_fixtures.py``).
* A source scan finds no such import anywhere in them.
* Entry points that create tensors (the session's ``MonoTracker``, the
  port's ``sim.render_frame`` and ``prng.uniform``, the ``System`` facade
  and its settings loader included) run on CUDA unless told otherwise:
  with no GPU and no ``device=``, they raise instead of running on the CPU;
  so does ``make_slam_mesh`` without an explicit device list.
* The port imports no PyYAML, OpenCV or matplotlib at import time (the
  GPU machine has none): the fresh interpreter blocks them too.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from orb_slam_fusion_tpu_torch import lie, sim, synth
from orb_slam_fusion_tpu_torch.engine import MonoTracker, SlamConfig
from orb_slam_fusion_tpu_torch.frontend.extractor import (OrbParams,
                                                          inv_scale_sigma2)
from orb_slam_fusion_tpu_torch.map import convert
from orb_slam_fusion_tpu_torch.map.map_state import make_empty_map
from orb_slam_fusion_tpu_torch.utils import prng

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "orb_slam_fusion_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["orb_slam_fusion_tpu"] = None
# the GPU machine has no PyYAML, OpenCV or matplotlib
sys.modules["yaml"] = None
sys.modules["cv2"] = None
sys.modules["matplotlib"] = None
import orb_slam_fusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
assert chip_smoke._fixtures().ba_problem_arrays
bad = [m for m in sys.modules if m.split(".")[0] in (
       "jax", "orb_slam_fusion_tpu", "yaml", "cv2", "matplotlib")]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def test_port_and_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) >= 65   # every module


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_scan_finds_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "torch_fixtures.py"]
    assert len(files) >= 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top != "jax", f"{f}: imports {name}"
            assert top != "orb_slam_fusion_tpu", f"{f}: imports {name}"
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f


def test_port_never_imports_yaml_and_draws_lazily():
    """The settings files are parsed without PyYAML, anywhere in the port;
    OpenCV and matplotlib are imported only inside the functions that
    decode an image file or draw (``io/euroc.py::load_gray``,
    ``viz/drawers.py``), never at a module's top level."""
    for f in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(f.read_text(), filename=str(f))
        for name in _imports(f):
            assert name.split(".")[0] != "yaml", f"{f}: imports {name}"
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("cv2", "matplotlib"), \
                    f"{f}: imports {name} at import time"


def test_system_refuses_cpu_without_device(monkeypatch, tmp_path):
    """The System facade and its settings loader: CUDA unless told
    otherwise, as the trackers."""
    from orb_slam_fusion_tpu_torch.config import load_settings
    from orb_slam_fusion_tpu_torch.system import Sensor, System
    p = tmp_path / "s.yaml"
    p.write_text(chip_smoke_settings())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: System(sensor=Sensor.MONOCULAR,
                       config=SlamConfig(loop_closing=False)),
        lambda: System(settings_path=str(p), sensor=Sensor.IMU_STEREO),
        lambda: load_settings(str(p), "stereo-imu"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    import orb_slam_fusion_tpu_torch as port
    assert (port.System, port.Sensor) == (System, Sensor)
    s = System(settings_path=str(p), sensor=Sensor.IMU_STEREO,
               verbosity=0, device="cpu")
    assert s.tracker.map.mp_pos.device.type == "cpu"
    assert s.tracker.calib.Tbc_R.device.type == "cpu"
    assert s.tracker.cfg.orb.n_features == 1200


def chip_smoke_settings():
    import chip_smoke
    return chip_smoke.SYSTEM_SETTINGS_YAML


def test_entry_points_refuse_cpu_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: make_empty_map(4, 8, 4),
        lambda: lie.se3_identity(),
        lambda: inv_scale_sigma2(OrbParams()),
        lambda: synth.build_world(__import__("numpy").random.RandomState(0),
                                  16, 1, 8, 120, 160),
        lambda: convert.features_from_numpy({}, None),
        lambda: MonoTracker(SlamConfig(loop_closing=False)),
        lambda: sim.render_frame(sim.make_corridor_world(4, 50), 0,
                                 (400.0, 400.0, 376.0, 240.0), (480, 752),
                                 16),
        lambda: prng.uniform_bits(prng.PRNGKey(0), (4,)),
        lambda: prng.uniform(prng.PRNGKey(0), (4,)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # an explicit CPU request runs
    assert make_empty_map(4, 8, 4, device="cpu").mp_pos.device.type == "cpu"
    tr = MonoTracker(SlamConfig(loop_closing=False), device="cpu")
    assert tr.map.mp_pos.device.type == "cpu"


def test_mesh_refuses_cpu_without_devices(monkeypatch):
    """``make_slam_mesh`` with no GPU and no ``devices`` raises (it never
    falls back to the CPU), and so does a meshed tracker with no device;
    an explicit device list, a repeated CPU included, builds a mesh."""
    from orb_slam_fusion_tpu_torch.parallel import make_slam_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_slam_mesh, lambda: make_slam_mesh(8),
                 lambda: MonoTracker(SlamConfig(loop_closing=False,
                                                mesh_devices=8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert make_slam_mesh(devices=["cpu"] * 3).shape == {"mp": 3}


def test_stereo_entry_points_refuse_cpu_without_device(monkeypatch):
    """The stereo-family sessions and renderers: CUDA unless told
    otherwise, as the monocular ones."""
    import numpy as np
    from orb_slam_fusion_tpu_torch.engine.stereo_tracker import (
        FisheyeStereoTracker, RgbdTracker, StereoTracker)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SlamConfig(loop_closing=False)
    world = sim.make_corridor_world(4, 50)
    calls = [
        lambda: StereoTracker(cfg, 0.11),
        lambda: RgbdTracker(cfg, 0.08),
        lambda: FisheyeStereoTracker(cfg, cfg.cam_params, np.eye(4)),
        lambda: sim.render_stereo_frame(world, 0, cfg.cam_params, (480, 752),
                                        16, 0.11),
        lambda: sim.render_fisheye_stereo_frame(
            world, 0, (190.0, 190.0, 256.0, 256.0, 0.0, 0.0, 0.0, 0.0),
            (190.0, 190.0, 256.0, 256.0, 0.0, 0.0, 0.0, 0.0), (512, 512),
            16, np.eye(4)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    tr = StereoTracker(cfg, 0.11, device="cpu")
    assert tr.kf_uright.device.type == "cpu"


def test_inertial_entry_points_refuse_cpu_without_device(monkeypatch):
    """The inertial sessions and their calibration: CUDA unless told
    otherwise, as the visual ones."""
    import numpy as np
    from orb_slam_fusion_tpu_torch.engine import (FisheyeStereoVioTracker,
                                                  StereoVioTracker,
                                                  VioTracker)
    from orb_slam_fusion_tpu_torch.imu.preintegration import (make_calib,
                                                              zero_bias)
    calib = make_calib(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SlamConfig(loop_closing=False)
    calls = [
        lambda: make_calib(),
        lambda: zero_bias(),
        lambda: VioTracker(cfg, calib),
        lambda: StereoVioTracker(cfg, 0.11, calib),
        lambda: FisheyeStereoVioTracker(cfg, cfg.cam_params, np.eye(4),
                                        calib),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    tr = StereoVioTracker(cfg, 0.11, calib, device="cpu")
    assert tr.calib.Tbc_R.device.type == "cpu"
    assert tr.bias.gyro.device.type == "cpu"
    # the inertial merge is ported: merging the active map's two keyframes
    # behind three archived visual ones re-homes the tables on the CPU
    from orb_slam_fusion_tpu_torch.map.atlas import ArchivedMap
    old = make_empty_map(8, 16, 4, device="cpu")
    old = old._replace(kf_timestamp=torch.arange(8, dtype=torch.float32))
    tr.kf_vel = [np.ones(3, np.float32), 2 * np.ones(3, np.float32)]
    tr.kf_bias = [zero_bias("cpu")] * 2
    tr.kf_pre = [None, None]
    tr.kf_time = [5.0, 6.0]
    tr.kf_raw = [None, None]
    tr.map = tr.map._replace(n_kf=torch.tensor(5, dtype=torch.int32))
    S = lie.Sim3(torch.tensor(2.0), torch.eye(3), torch.zeros(3))
    tr._on_maps_merged(ArchivedMap(old, None, None, None), 3, S)
    assert tr.kf_time == [0.0, 1.0, 2.0, 5.0, 6.0]
    np.testing.assert_array_equal(tr.kf_vel[4], [4.0, 4.0, 4.0])
    assert tr.cur_vel.device.type == "cpu"
    assert tr.kf_bias[0].gyro.device.type == "cpu"


def test_place_and_loop_entry_points_refuse_cpu_without_device(
        monkeypatch, tmp_path):
    """The vocabularies, the loop closer, the Sim3 identity and the
    vocabulary loaders: CUDA unless told otherwise."""
    import numpy as np
    from orb_slam_fusion_tpu_torch.engine.loop_closing import LoopCloser
    from orb_slam_fusion_tpu_torch.place import (
        load_tree_binary, make_vocabulary, save_tree_binary,
        train_vocabulary)
    from orb_slam_fusion_tpu_torch.place.vocabulary import (
        load_vocabulary_binary, save_vocabulary_binary)
    desc = np.random.RandomState(0).randint(
        0, 2 ** 32, (64, 8), dtype=np.uint64).astype(np.uint32)
    tree = train_vocabulary(desc, k=4, levels=2, device="cpu")
    save_tree_binary(str(tmp_path / "t.bin"), tree, 2)
    save_vocabulary_binary(str(tmp_path / "v.bin"),
                           make_vocabulary(16, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SlamConfig(orb=OrbParams(n_features=16), max_keyframes=8)
    calls = [
        lambda: make_vocabulary(16),
        lambda: train_vocabulary(desc, k=4, levels=2),
        lambda: load_tree_binary(str(tmp_path / "t.bin")),
        lambda: load_vocabulary_binary(str(tmp_path / "v.bin")),
        lambda: LoopCloser(cfg, 8, 16),
        lambda: lie.sim3_identity(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    lc = LoopCloser(cfg, 8, 16, device="cpu")
    assert lc.db.bow.device.type == "cpu"
    assert load_tree_binary(str(tmp_path / "t.bin"), "cpu")[1] == 2


def test_every_tracker_runs_at_the_default_config():
    """Every tracker of the port constructs at ``SlamConfig()`` as is
    (loop closing on: a loop closer, its database and an atlas; the
    fisheye rigs with a Kannala-Brandt camera in place of the default
    pinhole one) and runs
    frames through its entry point: two empty frames each, and two
    frames of the stereo e2e sequence through ``StereoTracker`` (its
    bootstrap and one tracked frame), whose bootstrap keyframe enters the
    database."""
    import numpy as np
    import chip_smoke
    from orb_slam_fusion_tpu_torch.engine import (FisheyeStereoVioTracker,
                                                  StereoVioTracker,
                                                  VioTracker)
    from orb_slam_fusion_tpu_torch.engine.stereo_tracker import (
        FisheyeStereoTracker, RgbdTracker, StereoTracker)
    from orb_slam_fusion_tpu_torch.imu.preintegration import make_calib
    cfg = SlamConfig()
    calib = make_calib(device="cpu")
    kb8 = (190.0, 190.0, 256.0, 256.0, 0.0, 0.0, 0.0, 0.0)
    fcfg = cfg._replace(cam_model="kannala_brandt8", cam_params=kb8)
    nf = cfg.orb.n_features
    empty = sim.features_on(chip_smoke._empty_features_numpy(nf), "cpu")
    imu = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
           np.zeros(0))
    trackers = {
        "mono": (MonoTracker(cfg, device="cpu"),
                 lambda t, k: t.process_features(empty, 0.05 * k)),
        "stereo": (StereoTracker(cfg, 0.11, device="cpu"),
                   lambda t, k: t.process_stereo_features(empty, empty,
                                                          0.05 * k)),
        "rgbd": (RgbdTracker(cfg, 0.08, device="cpu"),
                 lambda t, k: t.process_rgbd_features(
                     empty, torch.zeros(nf), 0.05 * k)),
        "fisheye_stereo": (FisheyeStereoTracker(fcfg, kb8, np.eye(4),
                                                device="cpu"),
                           lambda t, k: t.process_stereo_features(
                               empty, empty, 0.05 * k)),
        "vio": (VioTracker(cfg, calib, device="cpu"),
                lambda t, k: t.process_frame_imu(empty, 0.05 * k, *imu)),
        "stereo_vio": (StereoVioTracker(cfg, 0.11, calib, device="cpu"),
                       lambda t, k: t.process_stereo_imu(
                           empty, empty, 0.05 * k, *imu)),
        "fisheye_stereo_vio": (FisheyeStereoVioTracker(
            fcfg, kb8, np.eye(4), calib, device="cpu"),
            lambda t, k: t.process_stereo_imu(empty, empty, 0.05 * k,
                                              *imu)),
    }
    for name, (tr, step) in trackers.items():
        assert tr.loop_closer is not None and tr.enable_atlas, name
        for k in range(2):
            step(tr, k)
        assert tr.state.name in ("NO_IMAGES", "NOT_INITIALIZED"), name
    world = sim.make_corridor_world(**chip_smoke.STEREO_WORLD)
    tr = StereoTracker(cfg, chip_smoke.STEREO_BASELINE, device="cpu")
    r = dict(chip_smoke.STEREO_RENDER, n_features=nf)
    r.pop("n_features")
    for k in range(2):
        fL, fR = sim.render_stereo_frame(world, k, cfg.cam_params,
                                         cfg.image_size, nf,
                                         chip_smoke.STEREO_BASELINE,
                                         device="cpu", **r)
        rec = tr.process_stereo_features(fL, fR, float(world.timestamps[k]))
        assert rec.state in ("init-done", "ok"), (k, rec.state)
    assert bool(tr.loop_closer.db.present[0])


# torch's transcendentals round apart from the reference's (XLA:CPU's own
# exp and log, glibc's sinf, cosf, tanf, atan2f): the port takes them from
# utils/libm.py (the octave powers 1.2 ** k included). The library's stays
# where ROADMAP C15 leaves it.
_LIBM_FUNCS = {"sin", "cos", "tan", "atan2", "arctan2", "exp", "log", "pow",
               "exp_", "log_", "pow_", "float_power"}
_LEFT = sorted([
    # so3_exp's and the left Jacobian's sin and cos: the reference's moved
    # the flat inertial steps' parity tests past their bounds (VIBA1 init,
    # the seeded stereo VI-BA, the chained VIBA1 step, the sync image
    # session); ROADMAP C15 names them open
    ("lie.py", "torch.sin(th)"), ("lie.py", "torch.sin(th)"),
    ("lie.py", "torch.cos(th)"), ("lie.py", "torch.cos(th)"),
    # Python or numpy numbers, not tensors
    ("frontend/extractor.py", "f ** num_levels"),
    ("frontend/extractor.py", "f ** l"),
    ("frontend/extractor.py", "params.scale_factor ** l"),
    ("frontend/extractor.py", "params.scale_factor ** (2 * l)"),
    ("frontend/pyramid.py", "scale ** l"),
    ("map/map_state.py", "scale ** -(num_levels - 1)"),
    ("sim.py", "1.2 ** rng.uniform(0.0, 3.0, len(pts))"),
])


def test_port_takes_no_library_transcendental_outside_libm():
    """No ``torch.sin/cos/tan/atan2/exp/log/pow`` (nor such a method, nor
    ``**`` with a non-constant exponent) anywhere in the port but
    ``utils/libm.py``, except the sites of ``_LEFT``."""
    found, seen = [], []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        if rel == "utils/libm.py":
            continue
        src = path.read_text()
        for node in ast.walk(ast.parse(src)):
            seg = None
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _LIBM_FUNCS
                    and not (isinstance(node.func.value, ast.Name)
                             and node.func.value.id in ("np", "math",
                                                        "Verbose", "libm"))):
                seg = ast.get_source_segment(src, node)
                if seg.startswith("torch.pow(") and seg.endswith(")"):
                    seg = seg[:seg.index(", e)") + 4]
            elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
                r = node.right
                if isinstance(r, ast.UnaryOp):
                    r = r.operand
                if not isinstance(r, ast.Constant):
                    seg = ast.get_source_segment(src, node)
            if seg is None:
                continue
            key = (rel, " ".join(seg.split()).replace("( ", "("))
            if key in _LEFT:
                seen.append(key)
            else:
                found.append(f"{rel}:{node.lineno}: {seg}")
    assert not found, found
    assert sorted(seen) == _LEFT, (sorted(seen), _LEFT)  # each, once
