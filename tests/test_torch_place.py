"""Parity: place recognition (vocabularies, keyframe database, BoW
matching) against the JAX package.

Descriptors are seeded uint32 words made with numpy (noisy copies of a
few "places"), handed to the JAX package as uint32 and to the port as
int32 bit patterns. Exact: the seeded flat codebook, flat and tree word
ids and direct-index nodes, the trained tree (centroids, children, words;
its idf weights too), every load/save round trip across the packages
(DBoW2 text, the packed binary format, the flat binary and text formats),
``KeyFrameDatabase.query`` ids (after ``remove``, ``permute`` and
``grow`` too), ``search_by_bow`` and ``rotation_consistency_mask``. BoW
weights, L1 scores and query scores: 1e-6 (float32 sums over thousands
of words in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu.frontend import matcher as jmatch
from orb_slam_fusion_tpu.place import database as jdb
from orb_slam_fusion_tpu.place import tree_vocabulary as jtree
from orb_slam_fusion_tpu.place import vocabulary as jvoc
from orb_slam_fusion_tpu_torch.frontend import matcher as tmatch
from orb_slam_fusion_tpu_torch.map.convert import desc_to_torch
from orb_slam_fusion_tpu_torch.place import database as tdb
from orb_slam_fusion_tpu_torch.place import tree_vocabulary as ttree
from orb_slam_fusion_tpu_torch.place import vocabulary as tvoc

CPU = "cpu"


def _desc(rng, n):
    return rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def _noisy(rng, d, flips=4):
    d = d.copy()
    n = d.shape[0]
    for _ in range(flips):
        w = rng.randint(0, 8, n)
        b = rng.randint(0, 32, n).astype(np.uint32)
        d[np.arange(n), w] ^= (np.uint32(1) << b)
    return d


def _D(d):
    return desc_to_torch(d, CPU)


def _valid(n, rng, p=0.9):
    return rng.rand(n) < p


@pytest.fixture(scope="module")
def tree():
    rng = np.random.RandomState(3)
    train = _desc(rng, 600)
    return (jtree.train_vocabulary(train, k=4, levels=3, seed=0),
            ttree.train_vocabulary(train, k=4, levels=3, seed=0,
                                   device=CPU), train)


def _same_tree(jv, tv):
    np.testing.assert_array_equal(tv.node_desc.numpy().view(np.uint32),
                                  np.asarray(jv.node_desc))
    for f in ("children_idx", "word_id", "word_node"):
        np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                      np.asarray(getattr(jv, f)), err_msg=f)
    np.testing.assert_array_equal(tv.word_weight.numpy(),
                                  np.asarray(jv.word_weight))


def test_flat_vocabulary_quantize_and_bow():
    jv = jvoc.make_vocabulary(1024)
    tv = tvoc.make_vocabulary(1024, device=CPU)
    np.testing.assert_array_equal(tv.words.numpy().view(np.uint32),
                                  np.asarray(jv.words))
    rng = np.random.RandomState(0)
    d = _desc(rng, 300)
    v = _valid(300, rng)
    wj = np.asarray(jvoc.quantize(jv, jnp.asarray(d), jnp.asarray(v)))
    wt = tvoc.quantize(tv, _D(d), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(wt, wj)
    bj = np.asarray(jvoc.bow_vector(jv, jnp.asarray(d), jnp.asarray(v)))
    bt = tvoc.bow_vector(tv, _D(d), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(bt, bj, atol=1e-6)
    ws = np.abs(rng.randn(6, 1024)).astype(np.float32)
    ws /= ws.sum(1, keepdims=True)
    np.testing.assert_allclose(
        tvoc.l1_score(torch.from_numpy(np.array(bj)), torch.from_numpy(ws)).numpy(),
        np.asarray(jvoc.l1_score(jnp.asarray(bj), jnp.asarray(ws))),
        atol=1e-6)


def test_tree_training_and_descent(tree):
    jv, tv, train = tree
    _same_tree(jv, tv)
    assert tv.depth() == jv.depth() == 3
    rng = np.random.RandomState(4)
    d = np.concatenate([_noisy(rng, train[:200]), _desc(rng, 100)])
    v = _valid(300, rng)
    for direct in (None, 1, 2):
        wj, nj = jtree.quantize_tree(jv, jnp.asarray(d), jnp.asarray(v), 3,
                                     direct_level=direct)
        wt, nt = ttree.quantize_tree(tv, _D(d), torch.from_numpy(v), 3,
                                     direct_level=direct)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(
        ttree.bow_vector_tree(tv, _D(d), torch.from_numpy(v), 3).numpy(),
        np.asarray(jtree.bow_vector_tree(jv, jnp.asarray(d),
                                         jnp.asarray(v), 3)), atol=1e-6)


def test_tree_formats_round_trip(tree, tmp_path):
    jv, tv, _ = tree
    jtree.save_tree_text(str(tmp_path / "j.txt"), jv, 3)
    ttree.save_tree_text(str(tmp_path / "t.txt"), tv, 3)
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt"
                                                ).read_text()
    t2, L = ttree.load_tree_text(str(tmp_path / "j.txt"), CPU)
    j2, _ = jtree.load_tree_text(str(tmp_path / "j.txt"))
    assert L == 3
    _same_tree(j2, t2)
    jtree.save_tree_binary(str(tmp_path / "j.bin"), jv, 3)
    ttree.save_tree_binary(str(tmp_path / "t.bin"), tv, 3)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin"
                                                 ).read_bytes()
    t3, L = ttree.load_tree_binary(str(tmp_path / "j.bin"), CPU)
    j3, _ = jtree.load_tree_binary(str(tmp_path / "j.bin"))
    assert L == 3
    _same_tree(j3, t3)
    _same_tree(jv, t3)


def test_flat_formats_round_trip(tmp_path):
    jv = jvoc.make_vocabulary(64, seed=2)
    tv = tvoc.make_vocabulary(64, seed=2, device=CPU)
    jvoc.save_vocabulary_binary(str(tmp_path / "j.bin"), jv)
    tvoc.save_vocabulary_binary(str(tmp_path / "t.bin"), tv)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin"
                                                 ).read_bytes()
    t2 = tvoc.load_vocabulary_binary(str(tmp_path / "j.bin"), CPU)
    np.testing.assert_array_equal(t2.words.numpy().view(np.uint32),
                                  np.asarray(jv.words))
    np.savetxt(tmp_path / "v.txt", np.asarray(jv.words), fmt="%d")
    t3 = tvoc.load_vocabulary_text(str(tmp_path / "v.txt"), CPU)
    j3 = jvoc.load_vocabulary_text(str(tmp_path / "v.txt"))
    np.testing.assert_array_equal(t3.words.numpy().view(np.uint32),
                                  np.asarray(j3.words))


@pytest.mark.parametrize("kind", ["flat", "tree"])
def test_database_queries(kind, tree):
    rng = np.random.RandomState(7 if kind == "flat" else 8)
    if kind == "flat":
        jv, tv, L = jvoc.make_vocabulary(1024), tvoc.make_vocabulary(
            1024, device=CPU), 0
    else:
        jv, tv, _ = tree
        L = 3
    K, n = 12, 200
    jd, td = jdb.KeyFrameDatabase(jv, K, L), tdb.KeyFrameDatabase(tv, K, L)
    places = [_desc(rng, n) for _ in range(8)]
    for i in range(8):
        d = _noisy(rng, places[i % 8])
        v = _valid(n, rng)
        jd.add(i, jnp.asarray(d), jnp.asarray(v))
        td.add(i, _D(d), torch.from_numpy(v))
    np.testing.assert_allclose(td.bow.numpy(), np.asarray(jd.bow),
                               atol=1e-6)

    def check(qd, excl):
        v = np.ones(n, bool)
        qj = jd.compute_bow(jnp.asarray(qd), jnp.asarray(v))
        qt = td.compute_bow(_D(qd), torch.from_numpy(v))
        ij, sj = jd.query(qj, jnp.asarray(excl), top_k=3)
        it, st = td.query(qt, torch.from_numpy(excl), top_k=3)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)

    excl = np.zeros(K, bool)
    excl[5] = True
    for p in (3, 5, 6):
        check(_noisy(rng, places[p]), excl)
    jd.remove(6)
    td.remove(6)
    check(_noisy(rng, places[6]), np.zeros(K, bool))
    order = np.array([1, 0, 2, 3, 7, 4, 6, 5, 8, 9, 10, 11])
    jd.permute(order)
    td.permute(order)
    check(_noisy(rng, places[3]), np.zeros(K, bool))
    jd.grow(20)
    td.grow(20)
    assert tuple(td.bow.shape) == tuple(jd.bow.shape)
    check(_noisy(rng, places[1]), np.zeros(20, bool))
    np.testing.assert_array_equal(td.present.numpy(),
                                  np.asarray(jd.present))


def test_search_by_bow_and_rotation_consistency(tree):
    jv, tv, train = tree
    rng = np.random.RandomState(9)
    d1 = np.concatenate([train[:150], _desc(rng, 50)])
    d2 = _noisy(rng, d1[rng.permutation(200)], flips=3)
    v1, v2 = _valid(200, rng), _valid(200, rng)
    _, n1 = jtree.quantize_tree(jv, jnp.asarray(d1), jnp.asarray(v1), 3,
                                direct_level=2)
    _, n2 = jtree.quantize_tree(jv, jnp.asarray(d2), jnp.asarray(v2), 3,
                                direct_level=2)
    ij, okj = jmatch.search_by_bow(n1, jnp.asarray(d1), jnp.asarray(v1), n2,
                                   jnp.asarray(d2), jnp.asarray(v2))
    N1, N2 = torch.from_numpy(np.asarray(n1)), torch.from_numpy(
        np.asarray(n2))
    it, okt = tmatch.search_by_bow(N1, _D(d1), torch.from_numpy(v1), N2,
                                   _D(d2), torch.from_numpy(v2))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 50
    a1 = rng.uniform(0, 2 * np.pi, 200).astype(np.float32)
    a2 = rng.uniform(0, 2 * np.pi, 200).astype(np.float32)
    a2[:120] = np.mod(a1[:120] + 0.3, 2 * np.pi).astype(np.float32)
    idx = np.arange(200, dtype=np.int32)
    idx[::7] = -1
    ok = (idx >= 0) & _valid(200, rng, 0.95)
    # angles behind the reference's own -1 index (its last element) or
    # exactly on a bin edge
    a1[3] = np.float32(2 * np.pi / 30 * 4)
    for keep in (1, 3):
        mj = jmatch.rotation_consistency_mask(
            jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(idx),
            jnp.asarray(ok), keep_bins=keep)
        mt = tmatch.rotation_consistency_mask(
            torch.from_numpy(a1), torch.from_numpy(a2), torch.from_numpy(idx),
            torch.from_numpy(ok), keep_bins=keep)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
