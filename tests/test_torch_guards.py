"""Guards on the PyTorch port's boundaries.

* The port and chip_smoke.py import no JAX and nothing of the JAX package,
  not even lazily: a fresh interpreter with both blocked imports every
  module of the port and chip_smoke's module-level code.
* A source scan finds no such import anywhere in them.
* Entry points that create tensors (the session's ``MonoTracker``, the
  port's ``sim.render_frame`` and ``prng.uniform`` included) run on CUDA
  unless told otherwise: with no GPU and no ``device=``, they raise
  instead of running on the CPU.
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
import orb_slam_fusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "orb_slam_fusion_tpu" or m.startswith("orb_slam_fusion_tpu.")]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def test_port_and_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) >= 20   # every module


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_scan_finds_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top != "jax", f"{f}: imports {name}"
            assert top != "orb_slam_fusion_tpu", f"{f}: imports {name}"
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f


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
    with pytest.raises(NotImplementedError, match="A13"):
        tr._on_maps_merged(None, 0, None)
