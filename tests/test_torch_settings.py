"""The port's settings loader against the JAX package's.

Every settings file of ``tests/test_settings.py`` (EuRoC, EuRoC with the
Camera2 block, TUM-VI KB8, the legacy EuRoC and TUM RGB-D files, and the
resize and atlas variants), for every sensor string: the port's
``load_settings`` (its own YAML subset parser, no PyYAML) gives the same
``Settings`` as the JAX package's (PyYAML): the ``SlamConfig`` fields, the
calibration arrays, baseline, lapping, ``resize_to`` and ``image_scale``
exact, the rectification maps bit-exact; where the JAX loader raises, the
port raises the same exception type. Scalars resolve as PyYAML's YAML 1.1
``SafeLoader`` resolves them (exact, each form); lines outside the subset
raise ``ValueError`` naming the line. Tolerance: none (exact).
"""

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from orb_slam_fusion_tpu.config import load_settings as jload
from orb_slam_fusion_tpu.config import settings as jsettings
from orb_slam_fusion_tpu_torch.config import load_settings as tload
from orb_slam_fusion_tpu_torch.config.yaml_subset import (
    parse_settings_yaml, resolve_plain)
from tests.test_settings import (CAMERA2_BLOCK, EUROC_YAML,
                                 LEGACY_EUROC_YAML, LEGACY_TUM_RGBD_YAML,
                                 TUMVI_YAML)

torch.set_num_threads(1)

RESIZE = "Camera.newWidth: 376\nCamera.newHeight: 240\n"
FILES = {
    "euroc": EUROC_YAML,
    "euroc_camera2": EUROC_YAML + CAMERA2_BLOCK,
    "tumvi": TUMVI_YAML,
    "legacy_euroc": LEGACY_EUROC_YAML,
    "legacy_tum_rgbd": LEGACY_TUM_RGBD_YAML,
    "euroc_resized": EUROC_YAML + RESIZE + "System.thFarPoints: 20.0\n",
    "euroc_camera2_resized": EUROC_YAML + CAMERA2_BLOCK + RESIZE,
    "legacy_scaled": LEGACY_EUROC_YAML + "Camera.imageScale: 0.5\n",
    "euroc_atlas": EUROC_YAML + 'System.SaveAtlasToFile: "/a/save.npz"\n'
    "System.LoadAtlasFromFile: '/a/load.npz'\n",
    "tumvi_resized": TUMVI_YAML + "Camera.newWidth: 256\n"
    "Camera.newHeight: 256\n",
}
SENSORS = ("mono", "stereo", "rgbd", "mono-imu", "stereo-imu")


def _load(fn, path, sensor, **kw):
    try:
        return fn(path, sensor, **kw)
    except Exception as err:        # the reference's refusals are results
        return err


def assert_settings_equal(j, t):
    """Every field of a JAX ``Settings`` against the port's, exact."""
    assert set(j.slam._fields) == set(t.slam._fields)
    for name in j.slam._fields:
        a, b = getattr(j.slam, name), getattr(t.slam, name)
        if name == "orb":
            a, b = a._asdict(), b._asdict()
        assert a == b, name
    for name in ("baseline", "th_depth", "fps", "distortion", "load_atlas",
                 "save_atlas", "rgb", "cam2_params", "lapping", "resize_to",
                 "th_far_points", "depth_map_factor", "image_scale"):
        a, b = getattr(j, name), getattr(t, name)
        assert type(a) is type(b) and a == b, name
    for name in ("T_c1_c2",):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (j.rect_maps is None) == (t.rect_maps is None)
    if j.rect_maps is not None:
        for a, b in zip(j.rect_maps, t.rect_maps):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
    assert (j.calib is None) == (t.calib is None)
    if j.calib is not None:
        assert j.calib._fields == t.calib._fields
        for name in j.calib._fields:
            a = np.asarray(getattr(j.calib, name))
            b = getattr(t.calib, name).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("settings")
    out = {}
    for name, text in FILES.items():
        out[name] = str(d / f"{name}.yaml")
        with open(out[name], "w") as f:
            f.write(text)
    return out


@pytest.mark.parametrize("name", sorted(FILES))
def test_settings_equal_jax(files, name):
    for sensor in SENSORS:
        j = _load(jload, files[name], sensor)
        t = _load(tload, files[name], sensor, device="cpu")
        if isinstance(j, Exception):
            assert type(t) is type(j), (sensor, j, t)
            continue
        assert not isinstance(t, Exception), (sensor, t)
        assert_settings_equal(j, t)


def test_card_settings_are_the_tests():
    """chip_smoke.py's copy of the EuRoC settings (the system_session
    phase) is tests/test_settings.py's EUROC_YAML + CAMERA2_BLOCK."""
    assert chip_smoke.SYSTEM_SETTINGS_YAML == EUROC_YAML + CAMERA2_BLOCK


SCALARS = ['"1.0"', "1.0", "1e-5", "1.0e5", "1.0e+5", "3.e-03", "20", "-20",
           "+7", "0", "-0", "010", "08", "0x1F", "0b101", "1_000", "1:30",
           "1:30.5", "-0.28340811", "1.76187114e-05", ".5", "0.", "-.inf",
           ".NaN", "'PinHole'", "PinHole", '"Kannala\\tBrandt"',
           "'it''s'", "yes", "No", "TRUE", "off", "y", "~", "null", "",
           "/path/to/atlas.npz", "a b c", "1.0 # comment", "x#y",
           "1e-5 # c", "-", "1.2.3", "0o17"]


@pytest.mark.parametrize("form", SCALARS)
def test_scalar_forms_resolve_as_pyyaml(form):
    text = f"%YAML:1.0\nKey.name: {form}\n"
    try:
        want = yaml.load(text.split("\n", 1)[1],
                         Loader=jsettings._get_loader())
    except yaml.YAMLError:
        with pytest.raises(ValueError, match="settings line 2"):
            parse_settings_yaml(text)
        return
    got = parse_settings_yaml(text)
    assert got.keys() == want.keys()
    a, b = got["Key.name"], want["Key.name"]
    assert type(a) is type(b), (form, a, b)
    assert a == b or (a != a and b != b), (form, a, b)
    if form.strip() and not form.startswith(("'", '"')):
        c = resolve_plain(form.split(" #")[0].strip())
        assert type(c) is type(b) and (c == b or c != c)


def test_matrix_and_comments_parse_as_pyyaml():
    """The opencv-matrix node (data spanning lines, integer entries,
    comments inside) and comment lines, as the JAX loader reads them."""
    text = """%YAML:1.0
# a comment line
---
File.version: "1.0"   # trailing comment
M: !!opencv-matrix
  rows: 2
  cols: 3
  dt: d
  data: [ 1, -2.5, 3.e-03,  # comment in the list
          '4', 1e-5,
          6 ]

N: !!opencv-matrix
  rows: 1
  cols: 2
  data: [0.5,0.25]
"""
    want = yaml.load("\n".join(ln for ln in text.splitlines()
                               if not ln.strip().startswith("%YAML")),
                     Loader=jsettings._get_loader())
    got = parse_settings_yaml(text)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype == np.float64
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]


@pytest.mark.parametrize("text", [
    "Camera.fx 458.654\n",              # no colon
    "Key: [1, 2]\n",                    # flow sequence outside a matrix
    "Key: {a: 1}\n",
    "Key:\n  nested: 1\n",              # nested block
    "  Indented: 1\n",
    "Key: 'unterminated\n",
    'Key: "bad \\q escape"\n',
    "Key: &anchor 1\n",
    "Key: *alias\n",
    "Key: |\n  block\n",
    "Key: !!str 1\n",
    "Key: a: b\n",
    "Key: 2001-12-14\n",                # a YAML timestamp
    "M: !!opencv-matrix\n  rows: 2\n  cols: 2\n  data: [1, 2, 3]\n",
    "M: !!opencv-matrix\n  rows: 1\n  cols: 2\n  data: [1, 2\n",
    "M: !!opencv-matrix\n  rows: 1\n  cols: 2\n  data: [1,, 2]\n",
    "M: !!opencv-matrix\n  rows: 1\n  cols: 2\n  data: [1 2]\n",
    "M: !!opencv-matrix\n  rows: 1\n  cols: 1\n  data: [1]\n  extra: 1\n",
    "M: !!opencv-matrix\n  rows: 1\n  data: [1]\n",
    "%YAML:1.0\n",                      # no keys
])
def test_unreadable_lines_raise(text):
    with pytest.raises(ValueError, match="settings"):
        parse_settings_yaml(text)


def test_version_and_camera_errors(tmp_path):
    """The version guard (an unquoted 1.0 is a float and fails it, as in
    the JAX package), the legacy fallback's missing keys and an unknown
    camera type raise the same errors in both packages."""
    cases = {
        "future": ('File.version: "2.0"\nCamera.type: "PinHole"\n',
                   ValueError),
        "float_version": ("File.version: 1.0\nCamera.type: \"PinHole\"\n",
                          ValueError),
        "legacy_missing": ('Camera.type: "PinHole"\n', KeyError),
        "unknown_camera": (EUROC_YAML.replace('"PinHole"', '"Fisheye"'),
                           ValueError),
        "legacy_unknown_camera": (LEGACY_EUROC_YAML.replace(
            '"PinHole"', '"Fisheye"'), ValueError),
    }
    for name, (text, err) in cases.items():
        p = tmp_path / f"{name}.yaml"
        p.write_text(text)
        with pytest.raises(err):
            jload(str(p), "mono")
        with pytest.raises(err):
            tload(str(p), "mono", device="cpu")


def test_load_settings_refuses_cpu_without_device(tmp_path, monkeypatch):
    """The loader builds the IMU calibration on CUDA unless told
    otherwise: without a GPU and without ``device=`` it raises."""
    p = tmp_path / "e.yaml"
    p.write_text(EUROC_YAML)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tload(str(p), "stereo-imu")
    assert tload(str(p), "stereo-imu", device="cpu").calib.Tbc_R.device.type \
        == "cpu"
