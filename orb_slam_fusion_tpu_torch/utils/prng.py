"""Counter-based PRNG with jax.random's bits (threefry2x32).

Counterpart of the parts of ``jax.random`` the engine draws from, in the
configuration the reference runs (jax 0.9.0, ``jax_threefry_partitionable``
on, key implementation ``threefry2x32``): ``PRNGKey``, ``split``,
``fold_in`` and uniform floats, bit for bit. The threefry rounds follow
``jax/_src/prng.py`` (``threefry_seed``, ``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``) and the float fill follows
``jax/_src/random.py::_uniform``.

Keys are ``(2,)`` uint32 numpy arrays on the host, as JAX's raw key data;
the bulk bits are computed on the device the caller names (CUDA if none), in
int64 lanes masked to 32 bits (torch lacks uint32 arithmetic), so the CPU
and CUDA give the same integers.

``sample_minimal_sets`` is the counterpart of
``two_view._sample_minimal_sets``, which ranks ``jax.random.gumbel`` values
and takes ``lax.top_k``. The Gumbel value is ``-log(-log(u))`` of a uniform
``u`` drawn with ``minval = finfo(float32).tiny``: a strictly increasing
function of ``u``, so ranking by ``u`` picks the same indices in the same
order, with no ``log`` whose bits would have to match XLA's (torch's
``log`` differs from XLA:CPU's in 29,866 of 131,072 values of JAX's own
uniforms). A probe on jax 0.9.0 found the same top-k indices, in the same
order, from the uniforms as from the Gumbel values in all 30,720 rows tried
(40 keys, (256, 512) and (256, 1024), k = 4 and 8);
``tests/test_torch_prng.py`` holds the port's selection index-exact
against the reference's, k = 32 with sparse masks included.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter pairs ``(x1, x2)``
    (int64 tensors holding uint32 values) under the key ``(k1, k2)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def _key_words(key) -> Tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a threefry key is (2,) uint32, got {k.shape}")
    return int(k[0]), int(k[1])


def _hash_host(key, x1: Sequence[int], x2: Sequence[int]) -> np.ndarray:
    k1, k2 = _key_words(key)
    a, b = threefry2x32(k1, k2, torch.tensor(x1, dtype=torch.int64),
                        torch.tensor(x2, dtype=torch.int64))
    return a.numpy().astype(np.uint32), b.numpy().astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed mod 2^32)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return np.array([0, seed & _M32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) uint32 keys."""
    a, b = _hash_host(key, [0] * num, list(range(num)))
    return np.stack([a, b], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    a, b = _hash_host(key, [0], [int(data) & _M32])
    return np.array([a[0], b[0]], dtype=np.uint32)


def uniform_bits(key, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """32 random bits per element, as ``jax.random.bits`` draws them:
    int64 tensor of uint32 values on ``device`` (CUDA if None)."""
    k1, k2 = _key_words(key)
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    a, b = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (a ^ b).reshape(shape)


def uniform(key, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits fill the mantissa
    of a float in [1, 2), shifted to [0, 1), scaled and clamped below.
    XLA fuses the scale and shift into one multiply-add, rounded once
    (here through float64, where the product is exact)."""
    bits = uniform_bits(key, shape, device)
    fl = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=fl.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=fl.device)
    scaled = ((fl - 1.0).double() * (hi - lo).double()
              + lo.double()).float()
    return torch.maximum(lo, scaled)


TINY = float(np.finfo(np.float32).tiny)


def sample_minimal_sets(key, valid: torch.Tensor, n_hyp: int, k: int
                        ) -> torch.Tensor:
    """(n_hyp, k) int64 indices of ``valid`` entries, the reference's
    Gumbel top-k selection: each row ranks the uniforms behind
    ``jax.random.gumbel(key, (n_hyp, N))`` (minval ``tiny``) descending,
    invalid entries below every valid one, ties to the lowest index (a
    stable sort; ``torch.topk`` does not promise an order)."""
    n = valid.shape[0]
    u = uniform(key, (n_hyp, n), minval=TINY, device=valid.device)
    u = torch.where(valid[None, :], u, torch.full_like(u, -1.0))
    return torch.sort(u, dim=1, descending=True, stable=True)[1][:, :k]
