"""PyTorch port parity: the threefry PRNG behind the two-view RANSAC.

Held bit-exact against ``jax.random`` (jax 0.9.0, threefry partitionable,
as ``tests/conftest.py`` configures it): keys from ``PRNGKey``, ``split``
and ``fold_in``, the raw bits and the float32 uniforms, over a range of
seeds and shapes, (256, N) with N not a multiple of 4 included. The
minimal-set sampler is index-exact against the reference's Gumbel top-k
(``two_view._sample_minimal_sets``) for k = 4, 8 and 32, including masks
with fewer valid entries than k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu import two_view as jtv
from orb_slam_fusion_tpu_torch.utils import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 7, 79, 131 * 5 + 3, 12345, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (256, 513), (256, 1022)]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    kj = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(kj), kt)
    for num in (2, 3):
        np.testing.assert_array_equal(np.asarray(jax.random.split(kj, num)),
                                      prng.split(kt, num))
    for data in (0, 1, 31, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(kj, data)), prng.fold_in(kt, data))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniforms(shape):
    for seed in SEEDS[:4]:
        kj = jax.random.split(jax.random.PRNGKey(seed))[1]
        kt = prng.split(prng.PRNGKey(seed))[1]
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(kj, shape)),
            prng.uniform_bits(kt, shape, device="cpu").numpy().astype(
                np.uint32))
        tiny = np.finfo(np.float32).tiny
        for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0)):
            want = np.asarray(jax.random.uniform(kj, shape, minval=lo,
                                                 maxval=hi))
            got = prng.uniform(kt, shape, minval=lo, maxval=hi,
                                device="cpu").numpy()
            np.testing.assert_array_equal(want.view(np.int32),
                                          got.view(np.int32))


@pytest.mark.parametrize("k", [4, 8, 32])
def test_minimal_sets_match_gumbel_top_k(k):
    rng = np.random.RandomState(k)
    for seed in range(6):
        for n, p_valid in ((512, 0.6), (1024, 0.9), (300, 0.05), (40, 0.3),
                           (64, 0.0)):
            valid = rng.rand(n) < p_valid
            kj = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
            want = np.asarray(jtv._sample_minimal_sets(
                kj, jnp.asarray(valid), 256 if k < 32 else 1, k))
            got = prng.sample_minimal_sets(np.asarray(kj),
                                           torch.from_numpy(valid),
                                           256 if k < 32 else 1, k).numpy()
            np.testing.assert_array_equal(want, got,
                                          err_msg=f"seed {seed} n {n}")


def test_seed_range_is_checked():
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 32)
    with pytest.raises(ValueError):
        prng.split(np.zeros(3, np.uint32))
