"""PyTorch port parity: ORB front end (pyramid, FAST, selection, BRIEF).

Images are the bench's textured recipe at 120x160, made with numpy from a
seed. What is bit-exact and what is not:

* The pyramid is bit-exact: the port's resize rounds and orders each
  output pixel's taps as the reference's compiled ``jax.image.resize``
  does on the CPU (ROADMAP.md, C1), on these images and on the 480x752
  bench pyramid.
* So the whole extraction matches the reference bit for bit on every
  octave: keypoints, octaves, responses, angles, descriptors. The angle's
  moments are summed in the reference's compiled order and its arctangent
  is glibc's ``atan2f`` rebuilt in float32 steps (ROADMAP.md, C4).
* The resize reproduces the reference's weights and dot schedule at every
  image size (XLA:CPU's loop fusions, its Eigen contraction on the tests'
  8-thread pool and YNNPACK's dot, ROADMAP.md C3), portrait sizes
  included; the classes it does not reproduce (a side of one pixel, a
  shrink of about 30 times in one pass) raise instead of returning other
  bits.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu.frontend import extractor as je
from orb_slam_fusion_tpu.frontend import fast as jfast
from orb_slam_fusion_tpu.frontend import pyramid as jpyr
from orb_slam_fusion_tpu_torch import synth
from orb_slam_fusion_tpu_torch.frontend import extractor as te
from orb_slam_fusion_tpu_torch.frontend import fast as tfast
from orb_slam_fusion_tpu_torch.frontend import pyramid as tpyr
from orb_slam_fusion_tpu_torch.map.convert import features_to_numpy

torch.set_num_threads(1)

H, W, LEVELS, NFEAT = 120, 160, 4, 256


def _image(seed):
    return synth.textured_image(np.random.RandomState(seed), H, W, n_rect=20)


def _params():
    return (je.OrbParams(n_features=NFEAT, num_levels=LEVELS),
            te.OrbParams(n_features=NFEAT, num_levels=LEVELS))


def _jax_feats(f):
    return {k: np.asarray(getattr(f, k)) for k in te.Features._fields}


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_from_same_pyramid_is_bit_exact(seed):
    """Fed the reference's pyramid levels, every output is bit-exact,
    angles included."""
    img = jnp.asarray(_image(seed))
    pj, pt = _params()
    fj = _jax_feats(je.extract_features(img, pj))
    levels = [torch.from_numpy(np.array(lv))
              for lv in jpyr.build_pyramid(img, LEVELS, pj.scale_factor)]
    ft = features_to_numpy(te.extract_from_pyramid(levels, pt))
    for k in ("uv", "octave", "valid", "response", "angle", "desc"):
        np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)
    assert fj["valid"].sum() > 100


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_features_matches_reference(seed):
    """Whole extraction from the image: keypoint set (uv, octave, valid),
    responses, angles and descriptors on every octave bit-exact."""
    pj, pt = _params()
    img = _image(seed)
    fj = _jax_feats(je.extract_features(jnp.asarray(img), pj))
    ft = features_to_numpy(te.extract_features(torch.from_numpy(img), pt))
    for k in ("uv", "octave", "valid", "response", "angle", "desc"):
        np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)
    assert (fj["valid"] & (fj["octave"] > 0)).sum() > 50


def _compiled_weights(m, n):
    """The weights the reference's compiled resize uses: resizing the
    identity multiplies each weight by 1 and adds zeros, exactly."""
    eye = jnp.eye(m, dtype=jnp.float32)
    return np.asarray(jax.jit(
        lambda a: jax.image.resize(a, (m, n), "bilinear"))(eye))


def test_pyramid_and_blur():
    """Every pyramid level, eager and inside one jit, and the blur (as the
    reference runs it, compiled) are bit-exact; so are the resize weights
    against the ones the compiled resize uses, at every step of this
    pyramid and of the bench's."""
    img = _image(3)
    lj = jpyr.build_pyramid(jnp.asarray(img), LEVELS, 1.2)
    lk = jax.jit(lambda a: jpyr.build_pyramid(a, LEVELS, 1.2))(
        jnp.asarray(img))
    lt = tpyr.build_pyramid(torch.from_numpy(img), LEVELS, 1.2)
    assert [tuple(a.shape) for a in lj] == [tuple(b.shape) for b in lt]
    for a, k, b in zip(lj, lk, lt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(k), b.numpy())
    blur = jax.jit(jpyr.gaussian_blur)
    for lv in lj:
        np.testing.assert_array_equal(
            np.asarray(blur(lv)),
            tpyr.gaussian_blur(torch.from_numpy(np.array(lv))).numpy())
    for h, w, n in ((H, W, LEVELS), (480, 752, 8)):
        shapes = tpyr.level_shapes(h, w, n, 1.2)
        for (a, b), (c, d) in zip(shapes[:-1], shapes[1:]):
            for m, k in ((a, c), (b, d)):
                np.testing.assert_array_equal(
                    tpyr.resize_weights(m, k), _compiled_weights(m, k),
                    err_msg=f"{m}->{k}")


@pytest.mark.parametrize("kind", ["uniform", "textured"])
def test_bench_pyramid_bit_exact(kind):
    """The 480x752 bench pyramid (8 levels) is bit-exact against the
    reference's, built inside one jit, on a uniform-random image and on the
    bench's textured image."""
    if kind == "uniform":
        img = (np.random.default_rng(0).random((480, 752)) * 255).astype(
            np.float32)
    else:
        img = synth.textured_image(np.random.RandomState(0), 480, 752)
    lj = jax.jit(lambda a: jpyr.build_pyramid(a, 8, 1.2))(jnp.asarray(img))
    lt = tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)
    for lvl, (a, b) in enumerate(zip(lj, lt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"level {lvl}")


@pytest.mark.parametrize("seed", range(12))
def test_bench_angles_bit_exact(seed):
    """Whole extraction of a seeded 480x752 bench image (1024 features, 8
    octaves): angles and descriptors bit-exact, so every keypoint lands in
    the reference's steering bin."""
    img = synth.textured_image(np.random.RandomState(100 + seed), 480, 752)
    fj = _jax_feats(je.extract_features(jnp.asarray(img),
                                        je.OrbParams(n_features=1024)))
    ft = features_to_numpy(te.extract_features(torch.from_numpy(img),
                                               te.OrbParams(n_features=1024)))
    for k in ("uv", "octave", "valid", "angle", "desc"):
        np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)


def test_atan2f_is_the_references():
    """``atan2f`` against ``jnp.arctan2`` (XLA:CPU calls glibc's atan2f):
    bit-exact over every quadrant, the axes, signed zeros and the
    argument-reduction boundaries of atanf."""
    rng = np.random.RandomState(8)
    edges = np.array([7 / 16, 11 / 16, 19 / 16, 39 / 16, 2 ** 25, 2 ** -29],
                     np.float32)
    y = np.concatenate([rng.randn(20000) * 1e3, np.round(rng.randn(5000) * 50),
                        edges, -edges, [0.0, -0.0, 0.0, -0.0, 3.0, -3.0]])
    x = np.concatenate([rng.randn(20000) * 1e3, np.round(rng.randn(5000) * 50),
                        np.ones(6), np.ones(6), [2.0, 2.0, -2.0, -2.0, 0.0,
                                                 0.0]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    want = np.asarray(jax.jit(jnp.arctan2)(jnp.asarray(y), jnp.asarray(x)))
    got = te.atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("size", tpyr.VERIFIED_SIZES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pyramid_bit_exact_at_size(size):
    """8-level pyramids of the repo's sequences, the image session's
    240x376 and the common datasets' sizes, landscape, square and portrait
    (tests/torch_pyramid_probe.py's list), are bit-exact against the
    reference's, built inside one jit."""
    h, w = size
    img = (np.random.default_rng(h * 7 + w).random((h, w)) * 255).astype(
        np.float32)
    lj = jax.jit(lambda a: jpyr.build_pyramid(a, 8, 1.2))(jnp.asarray(img))
    lt = tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)
    for lvl, (a, b) in enumerate(zip(lj, lt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"level {lvl}")


_SWEEP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_goldens", "pyramid_sweep.json")


def _sha(a) -> str:
    h = hashlib.sha256()
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype).encode() + str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _sweep_cases():
    with open(_SWEEP) as fh:
        return json.load(fh)["cases"]


@pytest.mark.parametrize("case", _sweep_cases(),
                         ids=lambda c: f"{c['h']}x{c['w']}-{c['levels']}"
                                       f"-{c['scale']}")
def test_pyramid_sweep_matches_reference(case):
    """A seeded sweep of shapes of both orientations (sides 64-800) and
    five pyramids at other nLevels/scaleFactor: every level the port builds
    from its own previous one equals the reference's, by the per-level
    digests tests/make_torch_goldens.py wrote in the tests' regime (8 host
    devices)."""
    h, w, levels, scale = case["h"], case["w"], case["levels"], case["scale"]
    img = (np.random.RandomState(h * 7 + w).rand(h, w) * 255).astype(
        np.float32)
    assert _sha(img) == case["digests"][0]
    lv = torch.from_numpy(img)
    for lvl, s in enumerate(tpyr.level_shapes(h, w, levels, scale)[1:], 1):
        lv = tpyr.resize_bilinear(lv, s)
        assert _sha(lv.numpy()) == case["digests"][lvl], f"level {lvl}"


def test_sweep_is_admitted():
    """No step of the sweep's 53 pyramids falls in a refused class
    (``pyramid._refused``): deep levels of skinny images and other
    nLevels/scaleFactor included."""
    refused = [(c["h"], c["w"], a, b) for c in _sweep_cases()
               for a, b in zip(
                   tpyr.level_shapes(c["h"], c["w"], c["levels"],
                                     c["scale"])[:-1],
                   tpyr.level_shapes(c["h"], c["w"], c["levels"],
                                     c["scale"])[1:])
               if tpyr._refused(*a, *b)]
    assert refused == []


# Steps that read XLA's weight fusions under 32 pixels (height and width
# passes) and thin width passes whose weights pass 128 KiB (YNNPACK tiles
# the columns and blocks k per tile), the shapes ROADMAP C3 names.
FORMER_REFUSED = (((28, 400), (23, 333)), ((28, 400), (23, 400)),
                  ((27, 300), (23, 300)), ((20, 300), (17, 300)),
                  ((31, 200), (26, 200)), ((16, 64), (13, 64)),
                  ((400, 28), (400, 23)), ((26, 236), (26, 197)),
                  ((48, 300), (40, 250)), ((44, 409), (37, 340)),
                  ((40, 600), (33, 500)), ((30, 900), (30, 750)),
                  ((50, 1000), (42, 833)))


@pytest.mark.parametrize("src,dst", FORMER_REFUSED,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_former_refused_steps_bit_exact(src, dst):
    """Each of those steps is bit-exact against the jitted reference in the
    tests' regime, on a seeded image."""
    img = (np.random.RandomState(src[0] * 7 + src[1]).rand(*src)
           * 255).astype(np.float32)
    want = jax.jit(lambda a: jax.image.resize(a, dst, "bilinear"))(
        jnp.asarray(img))
    got = tpyr.resize_bilinear(torch.from_numpy(img), dst)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n", range(2, 32))
def test_resize_weights_under_32(n):
    """The weights for in-sizes under 32, down- and upscaling (to 90 also
    on every fifth size: enlarging to 88-95 unrolls the normalising fusion),
    equal the reference's compiled ones bit for bit: read off its resize of
    an identity (each output is one weight times 1.0), so no dot order
    enters."""
    outs = {max(2, n // 2), n - 1, 2 * n + 3} | ({90} if n % 5 == 0 else set())
    for m in sorted(outs - {n}):
        eye = jnp.eye(n, dtype=jnp.float32)
        want = np.asarray(jax.jit(lambda e: jax.image.resize(
            e, (m, n), "bilinear"))(eye)).T
        got = tpyr.resize_weights(n, m)
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.view(np.int32), err_msg=f"{n}->{m}")


@pytest.mark.parametrize("src,dst", [((673, 653), (289, 361)),
                                     ((1487, 769), (505, 769))],
                         ids=["last-n-block-one-column",
                              "last-row-tail-of-16"])
def test_eigen_edge_blocks_bit_exact(src, dst):
    """Two Eigen edge cases: a last n block one column wide (the kernel adds
    each k block onto that column in one chain) and a lone last row whose k
    block leaves a tail past its multiple of 16 (groups of 8, 4, 2, 1):
    bit-exact against the jitted reference."""
    img = (np.random.RandomState(2).rand(*src) * 255).astype(np.float32)
    want = jax.jit(lambda a: jax.image.resize(a, dst, "bilinear"))(
        jnp.asarray(img))
    got = tpyr.resize_bilinear(torch.from_numpy(img), dst)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("src,dst", [((1, 200), (1, 150)),
                                     ((200, 90), (150, 1)),
                                     ((451, 481), (7, 481))],
                         ids=["one-row", "one-column-result",
                              "taps-over-three-k-shards"])
def test_refused_classes_raise(src, dst):
    """The classes whose order is not reproduced raise instead of returning
    other bits (ROADMAP C3): a side of one pixel, whose dots XLA turns into
    vector products and reductions, and an Eigen pass where an output's
    taps meet three of its k shards."""
    with pytest.raises(NotImplementedError, match="C3"):
        tpyr.resize_bilinear(torch.zeros(src), dst)


def test_dot_plan_follows_thread_count():
    """The plan takes the reference's pool size: the height pass of
    240x320's level 4 is cut at k = 96 on 4 or more threads (Eigen shards
    the contracted axis), in one block on 1-3; the tests' regime is 8."""
    assert tpyr.REFERENCE_THREADS == 8
    assert tpyr._dot_plan("e", 139, 116, 185, 8)[1] == (0, 96)
    assert tpyr._dot_plan("e", 139, 116, 185, 4)[1] == (0, 96)
    for t in (1, 2, 3):
        assert tpyr._dot_plan("e", 139, 116, 185, t)[1] == (0,)


def test_fast_detect_and_nms():
    """corner score, threshold map and two-threshold detect: bit-exact."""
    lv = np.asarray(jpyr.build_pyramid(jnp.asarray(_image(4)), 2, 1.2)[1])
    tl = torch.from_numpy(np.array(lv))
    np.testing.assert_array_equal(np.asarray(jfast.corner_score(lv)),
                                  tfast.corner_score(tl).numpy())
    np.testing.assert_array_equal(np.asarray(jfast.fast_score_map(lv, 20.0)),
                                  tfast.fast_score_map(tl, 20.0).numpy())
    np.testing.assert_array_equal(np.asarray(jfast.detect(lv)),
                                  tfast.detect(tl).numpy())


def test_select_keypoints_tie_order():
    """Tied scores keep lax.top_k's order (lowest index first): bit-exact
    on an integer score map full of ties (H2)."""
    rng = np.random.RandomState(5)
    score = rng.randint(0, 4, (96, 128)).astype(np.float32) * 10
    for n_out in (40, 300):
        a = je.select_keypoints(jnp.asarray(score), n_out, 32, 4, 16)
        b = te.select_keypoints(torch.from_numpy(score), n_out, 32, 4, 16)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_brief_bits_and_features_per_level():
    """Steered BRIEF from the same patches and angles: bit-exact (the
    port gathers the pixel pairs the reference's +-1 product selects)."""
    rng = np.random.RandomState(6)
    patches = rng.randint(0, 255, (64, 31, 31)).astype(np.float32)
    patches[:8] = 100.0                     # flat patches: all-zero bits
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    ang[8:12] = [0.0, np.pi, -np.pi, 2 * np.pi / 120]
    np.testing.assert_array_equal(
        np.asarray(je.brief_descriptors(jnp.asarray(patches),
                                        jnp.asarray(ang))),
        te.brief_descriptors(torch.from_numpy(patches),
                             torch.from_numpy(ang)).numpy().view(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(je.ic_angle(jnp.asarray(patches))),
        te.ic_angle(torch.from_numpy(patches)).numpy())
    for n, lv in ((1024, 8), (256, 4), (100, 3)):
        assert te.features_per_level(n, lv, 1.2) == \
            je.features_per_level(n, lv, 1.2)
    np.testing.assert_array_equal(
        np.asarray(je.inv_scale_sigma2(je.OrbParams())),
        te.inv_scale_sigma2(te.OrbParams(), device="cpu").numpy())


def test_subpixel_refinement():
    """With subpixel=True (Harris parabola fit), from the same pyramid:
    keypoint set bit-exact, uv atol 1e-4 (the Harris products round as
    FMAs under XLA), descriptors bit-exact."""
    img = jnp.asarray(_image(7))
    pj = je.OrbParams(n_features=NFEAT, num_levels=LEVELS, subpixel=True)
    pt = te.OrbParams(n_features=NFEAT, num_levels=LEVELS, subpixel=True)
    fj = _jax_feats(je.extract_features(img, pj))
    levels = [torch.from_numpy(np.array(lv))
              for lv in jpyr.build_pyramid(img, LEVELS, pj.scale_factor)]
    ft = features_to_numpy(te.extract_from_pyramid(levels, pt))
    for k in ("octave", "valid", "desc"):
        np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)
    np.testing.assert_allclose(fj["uv"], ft["uv"], atol=1e-4)
    frac = fj["uv"] - np.round(fj["uv"])
    assert np.abs(frac[fj["valid"] & (fj["octave"] == 0)]).max() > 0.05
