"""The port's EuRoC reader against the JAX package's.

A ``mav0`` tree written to ``tmp_path`` (camera CSVs with a right frame
that matches no left one and a left frame without a right one, a 200 Hz
IMU CSV with comment lines, and a timestamps file that drops frames):
``EurocSequence.frames()`` equals the JAX package's. Timestamps agree
within 1e-12 s (the JAX package parses through its native library when
that is built, which may round the nanoseconds differently from the numpy
branch the port keeps); association indices, file paths and the IMU
windows' samples are exact. Also the three numpy routines on their own,
and the tree ``chip_smoke.write_mav0`` writes for the card's
``system_session`` phase.
"""

import numpy as np
import pytest

import chip_smoke
from orb_slam_fusion_tpu import native_bridge as nb
from orb_slam_fusion_tpu.io.euroc import EurocSequence as JSeq
from orb_slam_fusion_tpu_torch.io import EurocSequence as TSeq
from orb_slam_fusion_tpu_torch.io import euroc as teuroc
from orb_slam_fusion_tpu_torch import sim


def _write_tree(root, rng):
    mav = root / "mav0"
    t0 = 1403636579763555584            # a EuRoC MH01 timestamp (ns)
    left = t0 + np.arange(30) * 50_000_000
    right = left + rng.randint(-400_000, 400_000, len(left))
    right = np.delete(right, 7)          # left frame 7 has no right one
    right = np.insert(right, 12, left[11] + 25_000_000)   # a stray right
    for cam, ts in (("cam0", left), ("cam1", right)):
        (mav / cam / "data").mkdir(parents=True)
        with open(mav / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for t in ts:
                f.write(f"{t},{t}.png\n")
    imu_t = t0 - 20_000_000 + np.arange(320) * 5_000_000
    vals = rng.randn(len(imu_t), 6)
    (mav / "imu0").mkdir()
    with open(mav / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t, v in zip(imu_t, vals):
            f.write(f"{t}," + ",".join(f"{x:.17g}" for x in v) + "\n")
    stamps = root / "stamps.txt"
    np.savetxt(stamps, np.delete(left, [3, 4, 20]), fmt="%d")
    return str(root), str(stamps)


def _assert_frames_equal(fj, ft):
    assert len(fj) == len(ft) > 0
    for a, b in zip(fj, ft):
        assert abs(a.timestamp - b.timestamp) <= 1e-12
        assert a.img_left_path == b.img_left_path
        assert a.img_right_path == b.img_right_path
        for name in ("imu_acc", "imu_gyro"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        assert a.imu_t.shape == b.imu_t.shape
        np.testing.assert_allclose(a.imu_t, b.imu_t, rtol=0, atol=1e-12)


@pytest.mark.parametrize("stereo", [True, False])
@pytest.mark.parametrize("with_stamps", [False, True])
def test_sequence_equals_jax(tmp_path, stereo, with_stamps):
    root, stamps = _write_tree(tmp_path, np.random.RandomState(3))
    kw = dict(stereo=stereo, timestamps_file=stamps if with_stamps else None)
    sj, st = JSeq(root, **kw), TSeq(root, **kw)
    assert len(sj) == len(st)
    if stereo:
        np.testing.assert_array_equal(sj.right_of, st.right_of)
        assert (st.right_of < 0).any()
    _assert_frames_equal(list(sj.frames()), list(st.frames()))


def test_routines_equal_jax(tmp_path):
    root, _ = _write_tree(tmp_path, np.random.RandomState(4))
    mav = tmp_path / "mav0"
    tj, nj = nb.parse_euroc_cam(str(mav / "cam1" / "data.csv"))
    tt, nt = teuroc.parse_euroc_cam(str(mav / "cam1" / "data.csv"))
    assert nj == nt
    np.testing.assert_allclose(tj, tt, rtol=0, atol=1e-12)
    for a, b in zip(nb.parse_euroc_imu(str(mav / "imu0" / "data.csv")),
                    teuroc.parse_euroc_imu(str(mav / "imu0" / "data.csv"))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    rng = np.random.RandomState(5)
    q = np.sort(rng.uniform(0, 10, 200))
    r = np.sort(rng.uniform(0, 10, 150))
    for dt in (0.005, 0.02, 0.1):
        np.testing.assert_array_equal(nb.associate(q, r, dt),
                                      teuroc.associate(q, r, dt))


def test_chip_smoke_mav0_tree_reads_back(tmp_path):
    """The system_session phase's tree: 12 frames of the stereo-inertial
    sequence read back by the port (checked as the card checks it) and by
    the JAX package alike."""
    seq = sim.make_vio_sequence(**chip_smoke.VIO_SEQ)
    chip_smoke.write_mav0(str(tmp_path), seq, 12)
    ft = list(TSeq(str(tmp_path)).frames())
    chip_smoke.check_mav0_frames(ft, seq)
    assert len(ft) == 12 and len(ft[0].imu_t) == 0
    assert all(len(f.imu_t) == 10 for f in ft[1:])
    _assert_frames_equal(list(JSeq(str(tmp_path)).frames()), ft)


def test_load_gray_needs_opencv_only_when_called(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = (np.random.RandomState(0).rand(20, 30) * 255).astype(np.uint8)
    p = str(tmp_path / "a.png")
    cv2.imwrite(p, img)
    np.testing.assert_array_equal(teuroc.load_gray(p), img.astype(np.float32))
    with pytest.raises(FileNotFoundError):
        teuroc.load_gray(str(tmp_path / "missing.png"))
