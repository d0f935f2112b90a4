"""Atlas checkpoints: the port's against the JAX package's, both ways.

* A map whose every field holds seeded random values round-trips through
  the port's ``save_map``/``load_map`` field-exact.
* Interchange: a JAX ``save_map`` file loads into the port field-exact,
  and the port's file of the same map has the JAX file's key set, dtypes,
  shapes and values (descriptors as ``uint32`` words), so the JAX
  ``load_map`` reads it back to the same map.
* The vocabulary guard hashes the same bytes in both packages (the flat
  codebook's words, the tree vocabulary's ``node_desc``): each accepts the
  other's file and refuses one built with another vocabulary.
* ``tests/test_serialization.py::test_full_session_roundtrip``'s session
  (inertial state with raw IMU windows, an archived map, a loop edge):
  JAX ``System.save_atlas`` -> port ``System.load_atlas`` and back, every
  array exact; the re-preintegrated window within 1e-6 relative (the
  port's float64 host preintegration rounds as the reference's).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.io import serialization as jser
from orb_slam_fusion_tpu.map import make_empty_map as jempty
from orb_slam_fusion_tpu.place import make_vocabulary as jvocab
from orb_slam_fusion_tpu.place.tree_vocabulary import (
    train_vocabulary as jtrain)
from orb_slam_fusion_tpu_torch.io import serialization as tser
from orb_slam_fusion_tpu_torch.map.convert import (map_state_from_numpy,
                                                   map_state_to_numpy)
from orb_slam_fusion_tpu_torch.place import make_vocabulary as tvocab
from orb_slam_fusion_tpu_torch.place.tree_vocabulary import (
    train_vocabulary as ttrain)

torch.set_num_threads(1)


def _random_jax_map(seed=0, K=6, M=40, F=12):
    """A JAX MapState with seeded random values in every field (each
    field's dtype and shape kept)."""
    m = jempty(K, M, F)
    rng = np.random.RandomState(seed)
    fields = {}
    for name in m._fields:
        if name == "kf_pose":
            R = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(
                rng.randn(3).astype(np.float32)))) for _ in range(K)])
            fields[name] = jlie.SE3(jnp.asarray(R), jnp.asarray(
                rng.randn(K, 3).astype(np.float32)))
            continue
        a = np.asarray(getattr(m, name))
        if a.dtype == np.bool_:
            v = rng.rand(*a.shape) < 0.6
        elif a.dtype == np.uint32:
            v = rng.randint(0, 2 ** 32, a.shape, dtype=np.uint64)
        elif np.issubdtype(a.dtype, np.integer):
            v = rng.randint(-1, M, a.shape)
        else:
            v = rng.randn(*a.shape)
        fields[name] = jnp.asarray(np.asarray(v).astype(a.dtype))
    fields["n_kf"] = jnp.asarray(np.int32(K - 1))
    fields["n_mp"] = jnp.asarray(np.int32(M - 5))
    return m._replace(**fields)


def _jax_fields(m):
    out = {}
    for name in m._fields:
        v = getattr(m, name)
        out[name] = ((np.asarray(v.R), np.asarray(v.t)) if name == "kf_pose"
                     else np.asarray(v))
    return out


def _assert_map_equal(want, got):
    """Two field dicts (``map_state_to_numpy`` layout), dtype and bits."""
    assert want.keys() == got.keys()
    for name in want:
        a, b = want[name], got[name]
        pairs = zip(a, b) if name == "kf_pose" else [(a, b)]
        for x, y in pairs:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def _npz(path):
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jmap():
    return _random_jax_map()


def test_port_roundtrip(tmp_path, jmap):
    m = map_state_from_numpy(_jax_fields(jmap), "cpu")
    voc = tvocab(256, device="cpu")
    p = str(tmp_path / "map.npz")
    uright = torch.full((6, 12), -1.0)
    tser.save_map(p, m, voc.words, kf_uright=uright)
    m2, extras = tser.load_map(p, voc.words, device="cpu")
    _assert_map_equal(map_state_to_numpy(m), map_state_to_numpy(m2))
    np.testing.assert_array_equal(extras["kf_uright"], uright.numpy())
    assert m2.mp_pos.device.type == "cpu"


def test_jax_file_loads_into_port(tmp_path, jmap):
    p = str(tmp_path / "jax.npz")
    jser.save_map(p, jmap, jvocab(256).words,
                  kf_uright=jnp.full((6, 12), 2.5))
    m, extras = tser.load_map(p, tvocab(256, device="cpu").words,
                              device="cpu")
    _assert_map_equal(_jax_fields(jmap), map_state_to_numpy(m))
    assert extras["kf_uright"].dtype == np.float32
    np.testing.assert_array_equal(extras["kf_uright"], 2.5)


def test_port_file_is_the_jax_format(tmp_path, jmap):
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jser.save_map(pj, jmap, jvocab(256).words, n_archived=np.int64(0))
    tser.save_map(pt, map_state_from_numpy(_jax_fields(jmap), "cpu"),
                  tvocab(256, device="cpu").words, n_archived=np.int64(0))
    a, b = _npz(pj), _npz(pt)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    m, _ = jser.load_map(pt, jvocab(256).words)
    _assert_map_equal(_jax_fields(jmap), _jax_fields(m))


def test_vocab_guard_interchange(tmp_path, jmap):
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jser.save_map(pj, jmap, jvocab(256).words)
    tser.save_map(pt, map_state_from_numpy(_jax_fields(jmap), "cpu"),
                  tvocab(256, device="cpu").words)
    assert jser.vocab_checksum(jvocab(256).words) == tser.vocab_checksum(
        tvocab(256, device="cpu").words)
    other_t = tvocab(256, seed=99, device="cpu").words
    other_j = jvocab(256, seed=99).words
    for p in (pj, pt):
        tser.load_map(p, tvocab(256, device="cpu").words, device="cpu")
        jser.load_map(p, jvocab(256).words)
        with pytest.raises(ValueError, match="vocabulary checksum"):
            tser.load_map(p, other_t, device="cpu")
        with pytest.raises(ValueError, match="vocabulary checksum"):
            jser.load_map(p, other_j)
        tser.load_map(p, device="cpu")          # no vocabulary: no check


def test_tree_vocabulary_checksum_equal():
    """The tree vocabulary's guard hashes its node centroids as uint32 in
    both packages (``System._vocab_words``)."""
    desc = np.random.RandomState(1).randint(
        0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32)
    j = jtrain(desc, k=4, levels=2)
    t = ttrain(desc, k=4, levels=2, device="cpu")
    assert jser.vocab_checksum(j.node_desc) == tser.vocab_checksum(
        t.node_desc)


def _jax_session_system():
    """test_serialization.py::test_full_session_roundtrip's JAX session."""
    from orb_slam_fusion_tpu.config.settings import Settings
    from orb_slam_fusion_tpu.engine import SlamConfig
    from orb_slam_fusion_tpu.frontend.extractor import OrbParams
    from orb_slam_fusion_tpu.imu.preintegration import (
        ImuBias, make_calib, preintegrate_host)
    from orb_slam_fusion_tpu.map.atlas import ArchivedMap
    from orb_slam_fusion_tpu.system import Sensor, System
    from tests.test_serialization import _small_map

    cfg = SlamConfig(orb=OrbParams(n_features=8), max_keyframes=4,
                     max_map_points=16, vocab_words=256)
    st = Settings(slam=cfg, calib=make_calib(), baseline=0.0, th_depth=35.0,
                  fps=20.0, distortion=(), load_atlas=None, save_atlas=None)
    sys1 = System(settings=st, sensor=Sensor.IMU_MONOCULAR, verbosity=0)
    t = sys1.tracker
    t.map = _small_map()
    n_kf = int(t.map.n_kf)
    t.imu_initialized = True
    t._imu_stage = 2
    t._imu_init_time = 1.25
    t.bias = ImuBias(jnp.asarray([0.01, -0.02, 0.03]),
                     jnp.asarray([0.1, 0.2, -0.3]))
    t.cur_vel = jnp.asarray([0.5, 0.0, 0.1])
    t.kf_vel = [np.asarray([0.4, 0.0, 0.1], np.float32)] * n_kf
    t.kf_bias = [t.bias] * n_kf
    t.kf_time = [0.5 * k for k in range(n_kf)]
    raw = (np.full((5, 3), 0.2), np.full((5, 3), 0.01), np.full(5, 0.01))
    t.kf_raw = [None] * (n_kf - 1) + [raw]
    t.kf_pre = [None] * (n_kf - 1) + [
        preintegrate_host(*raw, t.bias, t.calib)]
    t.atlas.archived = [ArchivedMap(
        _random_jax_map(3, K=4, M=16, F=8), jnp.ones((4, 256)) * 0.5,
        jnp.ones(4, bool))]
    t.loop_closer.loop_edges = [
        (0, 2, jlie.Sim3(jnp.asarray(1.1), jnp.eye(3), jnp.asarray(
            [0.1, 0.2, 0.3])))]
    return sys1, cfg


def _port_system(cfg_j):
    from orb_slam_fusion_tpu_torch.config import Settings
    from orb_slam_fusion_tpu_torch.engine import SlamConfig
    from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
    from orb_slam_fusion_tpu_torch.imu.preintegration import make_calib
    from orb_slam_fusion_tpu_torch.system import Sensor, System
    cfg = SlamConfig(orb=OrbParams(n_features=8), max_keyframes=4,
                     max_map_points=16, vocab_words=256)
    st = Settings(slam=cfg, calib=make_calib(device="cpu"), baseline=0.0,
                  th_depth=35.0, fps=20.0, distortion=(), load_atlas=None,
                  save_atlas=None)
    return System(settings=st, sensor=Sensor.IMU_MONOCULAR, verbosity=0,
                  device="cpu")


def test_full_session_roundtrip_interchange(tmp_path):
    sys_j, cfg = _jax_session_system()
    pj = str(tmp_path / "jax_session.npz")
    sys_j.save_atlas(pj)
    sys_t = _port_system(cfg)
    sys_t.load_atlas(pj)
    tj, tt = sys_j.tracker, sys_t.tracker
    # the inertial state
    assert tt.imu_initialized and tt._imu_stage == 2
    assert tt._imu_init_time == 1.25
    np.testing.assert_array_equal(tt.bias.gyro.numpy(),
                                  np.asarray(tj.bias.gyro, np.float32))
    np.testing.assert_array_equal(tt.cur_vel.numpy(),
                                  np.asarray(tj.cur_vel, np.float32))
    assert tt.kf_time == tj.kf_time
    for a, b in zip(tt.kf_vel, tj.kf_vel):
        np.testing.assert_array_equal(a, b)
    assert [p is None for p in tt.kf_pre] == [p is None for p in tj.kf_pre]
    for name in ("dR", "dV", "dP", "dT"):
        np.testing.assert_allclose(
            getattr(tt.kf_pre[-1], name).numpy(),
            np.asarray(getattr(tj.kf_pre[-1], name)), rtol=1e-6, atol=1e-7)
    for a, b in zip(tt.kf_raw[-1], tj.kf_raw[-1]):
        np.testing.assert_array_equal(a, b)
    # the archived map, its BoW rows, the active map, the loop edge
    arch_j, arch_t = tj.atlas.archived[0], tt.atlas.archived[0]
    _assert_map_equal(_jax_fields(arch_j.map),
                      map_state_to_numpy(arch_t.map))
    np.testing.assert_array_equal(arch_t.bow.numpy(), np.asarray(arch_j.bow))
    np.testing.assert_array_equal(arch_t.present.numpy(),
                                  np.asarray(arch_j.present))
    _assert_map_equal(_jax_fields(tj.map), map_state_to_numpy(tt.map))
    (i, j, S), = tt.loop_closer.loop_edges
    assert (i, j) == (0, 2)
    Sj = tj.loop_closer.loop_edges[0][2]
    for name in ("s", "R", "t"):
        np.testing.assert_array_equal(getattr(S, name).numpy(),
                                      np.asarray(getattr(Sj, name)))
    assert tt.state.name == "LOST"
    # the database rebuilt from the map's keyframes, as the reference's
    np.testing.assert_array_equal(
        tt.loop_closer.db.present.numpy(),
        np.asarray(tj.map.kf_valid)[:4] & (np.arange(4) < int(tj.map.n_kf)))
    # back: the port's file is the JAX file, array for array
    pt = str(tmp_path / "port_session.npz")
    sys_t.save_atlas(pt)
    a, b = _npz(pj), _npz(pt)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sys_j2, _ = _jax_session_system()
    sys_j2.tracker.atlas.archived = []
    sys_j2.load_atlas(pt)
    t2 = sys_j2.tracker
    assert t2.imu_initialized and t2._imu_stage == 2
    assert len(t2.atlas.archived) == 1 and len(t2.loop_closer.loop_edges) == 1
    _assert_map_equal(_jax_fields(tj.atlas.archived[0].map),
                      _jax_fields(t2.atlas.archived[0].map))
