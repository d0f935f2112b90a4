"""Adversarial inputs for the masked Hamming match (no tests here).

Shared by ``test_torch_match.py`` (the plain version against the
reference's Pallas kernel in interpret mode, on the CPU) and
``test_torch_cuda.py`` (the CUDA kernel against the plain version, on the
card), so the kernel and its yardstick are pinned on the same edges. Each
case is a dict of numpy arrays in the public wrapper's argument order,
made from a seed; it imports neither JAX nor torch.
"""

import numpy as np

RESIDENT_MAX = 4096          # the kernel keeps at most this many in shared


def _base(rng, M, N, extent=(752.0, 480.0)):
    w, h = extent
    return dict(
        pred_uv=np.stack([rng.uniform(0, w, M), rng.uniform(0, h, M)],
                         1).astype(np.float32),
        mp_desc=rng.randint(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(
            np.uint32),
        mp_valid=np.ones(M, bool),
        radius=rng.uniform(5, 60, M).astype(np.float32),
        kp_uv=np.stack([rng.uniform(0, w, N), rng.uniform(0, h, N)],
                       1).astype(np.float32),
        kp_desc=rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(
            np.uint32),
        kp_valid=np.ones(N, bool),
        mp_octave=rng.randint(-1, 8, M).astype(np.int32),
        kp_octave=rng.randint(0, 8, N).astype(np.int32))


def _near(c, rng, rows, cols, bits=3):
    """Keypoints ``cols`` get row descriptors with a few bits flipped."""
    d = c["mp_desc"][rows].copy()
    for _ in range(bits):
        w = rng.randint(0, 8, len(rows))
        d[np.arange(len(rows)), w] ^= np.uint32(1) << rng.randint(
            0, 32, len(rows)).astype(np.uint32)
    c["kp_desc"][cols] = d


def borders(seed):
    """Keypoints on an integer lattice, on the bounding box's corners and
    exactly on window borders (d^2 == r^2 in exact float arithmetic), and
    windows whose edges fall on the lattice lines, where ~32 px cells of a
    752 px box also fall."""
    rng = np.random.RandomState(seed)
    c = _base(rng, 400, 900)
    gx, gy = np.meshgrid(np.arange(0, 753, 47), np.arange(0, 481, 32))
    lattice = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    c["kp_uv"][:len(lattice)] = lattice
    c["kp_uv"][len(lattice):len(lattice) + 4] = [[0, 0], [752, 480],
                                                 [0, 480], [752, 0]]
    # rows centred on lattice points, radius 5: keypoints at (+3, +4) pass
    # on the border exactly, (+3, +4.5) do not
    rows = np.arange(0, 200)
    cen = lattice[rng.randint(0, len(lattice), len(rows))]
    c["pred_uv"][rows] = cen
    c["radius"][rows] = 5.0
    k0 = len(lattice) + 4
    cols = np.arange(k0, k0 + len(rows))
    c["kp_uv"][cols] = cen + np.array([3.0, 4.0], np.float32)
    c["kp_uv"][cols[::2]] += np.array([0.0, 0.5], np.float32)
    _near(c, rng, rows, cols)
    # rows whose radius reaches exactly to lattice lines (47 and 32 px)
    c["radius"][200:300] = np.where(rng.rand(100) < 0.5, 47.0, 32.0)
    c["pred_uv"][200:300] = lattice[rng.randint(0, len(lattice), 100)]
    c["mp_octave"][rows] = c["kp_octave"][cols]
    return c


def cluster(seed, M=300, N=1024):
    """Most keypoints packed into one cell (within 2 px), with tied
    duplicates, and rows centred on the cluster and around it."""
    rng = np.random.RandomState(seed)
    c = _base(rng, M, N)
    n = 700
    c["kp_uv"][:n] = (np.array([400.0, 200.0], np.float32)
                      + rng.uniform(-1, 1, (n, 2)).astype(np.float32))
    c["kp_desc"][1:n:7] = c["kp_desc"][0]
    c["mp_desc"][:100] = c["kp_desc"][0]
    c["pred_uv"][:150] = (np.array([400.0, 200.0], np.float32)
                          + rng.uniform(-20, 20, (150, 2)).astype(np.float32))
    c["radius"][:150] = rng.uniform(0.5, 30, 150).astype(np.float32)
    return c


def radii(seed):
    """r = 0 (only keypoints exactly at the centre), -0, -1, huge and
    infinite r (every finite keypoint passes, those at 1e9 too), NaN r, NaN
    and infinite centres, invalid map points and keypoints."""
    rng = np.random.RandomState(seed)
    M, N = 256, 512
    c = _base(rng, M, N)
    c["kp_valid"][rng.rand(N) < 0.15] = False           # folded to 1e9
    specials = [0.0, -0.0, -1.0, 1e6, 3e9, np.inf, -np.inf, np.nan, 1e-30]
    for i, r in enumerate(specials):
        c["radius"][i * 20:(i + 1) * 20] = r
    c["pred_uv"][0:10] = c["kp_uv"][0:10]               # r = 0 exact hits
    c["pred_uv"][20:30] = c["kp_uv"][10:20]              # r = -0 exact hits
    c["pred_uv"][200:205, 0] = np.nan
    c["pred_uv"][205:210, 1] = np.nan
    c["pred_uv"][210:215, 0] = np.inf
    c["pred_uv"][215:220, 1] = -np.inf
    c["radius"][213:215] = np.inf                       # inf centre, inf r
    c["radius"][218:220] = np.inf
    c["mp_valid"][rng.rand(M) < 0.1] = False
    c["mp_desc"][:60] = c["kp_desc"][rng.randint(0, N, 60)]
    return c


def far_keypoints(seed):
    """Keypoints at 1e9 (valid ones too), off the image (negative, beyond
    it), at +-inf and NaN, and rows near and beyond the image edges."""
    rng = np.random.RandomState(seed)
    M, N = 256, 600
    c = _base(rng, M, N)
    c["kp_uv"][:40] = 1e9
    c["kp_uv"][40:80] = rng.uniform(-300, -1, (40, 2)).astype(np.float32)
    c["kp_uv"][80:120] = rng.uniform(760, 2000, (40, 2)).astype(np.float32)
    c["kp_uv"][120:125, 0] = np.inf
    c["kp_uv"][125:130, 1] = -np.inf
    c["kp_uv"][130:135] = np.nan
    c["kp_uv"][135:140] = 2e6                           # beyond the box
    c["pred_uv"][:60] = c["kp_uv"][40:100] + rng.uniform(
        -3, 3, (60, 2)).astype(np.float32)
    c["mp_desc"][:60] = c["kp_desc"][40:100]
    c["pred_uv"][60:70] = 1e9
    c["radius"][60:70] = 2.0
    c["kp_desc"][:10] = c["mp_desc"][60:70]
    return c


def tied_across_cells(seed):
    """The same descriptor at several keypoints in different cells, the
    higher index in the lower cell, so visiting cells in order meets the
    higher index first: the lowest index must still win and second ==
    best."""
    rng = np.random.RandomState(seed)
    c = _base(rng, 200, 800)
    rows = np.arange(100)
    a = 700 + np.arange(100) % 50        # high index, placed left/up
    b = np.arange(100) % 50              # low index, placed right/down
    cen = np.stack([rng.uniform(100, 650, 100),
                    rng.uniform(100, 380, 100)], 1).astype(np.float32)
    c["pred_uv"][rows] = cen
    c["radius"][rows] = 60.0
    c["kp_uv"][a[:50]] = cen[:50] - 40.0
    c["kp_uv"][b[:50]] = cen[:50] + 40.0
    c["kp_desc"][a[:50]] = c["mp_desc"][:50]
    c["kp_desc"][b[:50]] = c["mp_desc"][:50]
    c["mp_desc"][50:100] = c["mp_desc"][:50]
    c["mp_octave"][rows] = -1
    return c


def wide(seed):
    """A 3000x2000 px field with negative coordinates too: keypoints 1024
    px apart share a cell of the kernel's 32 x 32 torus of 32 px cells, and
    windows up to 400 px wrap it."""
    rng = np.random.RandomState(seed)
    c = _base(rng, 400, 1000, extent=(3000.0, 2000.0))
    c["kp_uv"] -= np.float32(500.0)
    c["pred_uv"] -= np.float32(500.0)
    c["kp_uv"][500:700] = c["kp_uv"][:200] + np.float32(1024.0)
    c["kp_desc"][500:700] = c["kp_desc"][:200]
    c["pred_uv"][:200] = c["kp_uv"][:200] + rng.uniform(
        -4, 4, (200, 2)).astype(np.float32)
    c["mp_desc"][:200] = c["kp_desc"][:200]
    c["radius"] = rng.uniform(5, 400, 400).astype(np.float32)
    c["radius"][:100] = 1030.0                     # reaches the alias too
    return c


def sizes(seed, M, N):
    """Plain random case at a given size (N = 1, M = 1, N beyond the
    shared-memory budget)."""
    rng = np.random.RandomState(seed)
    c = _base(rng, M, N)
    k = max(1, min(M, N) // 2)
    c["kp_desc"][:k] = c["mp_desc"][:k]
    c["kp_uv"][:k] = c["pred_uv"][:k] + 1.0
    near = slice(k, k + M // 4)                  # more rows around keypoint 0
    c["pred_uv"][near] = c["kp_uv"][0] + rng.uniform(
        -8, 8, (len(range(M)[near]), 2)).astype(np.float32)
    c["mp_valid"][k:][rng.rand(M - k) < 0.1] = False
    c["kp_valid"][1:][rng.rand(N - 1) < 0.1] = False
    return c


CASES = {
    "borders": lambda: borders(0),
    "cluster": lambda: cluster(1),
    "radii": lambda: radii(2),
    "far_keypoints": lambda: far_keypoints(3),
    "tied_across_cells": lambda: tied_across_cells(4),
    "wide": lambda: wide(9),
    "n1": lambda: sizes(5, 64, 1),
    "m1": lambda: sizes(6, 1, 300),
    "m1n1": lambda: sizes(7, 1, 1),
    "beyond_resident": lambda: sizes(8, 96, RESIDENT_MAX + 700),
}


# the System session's width (ORBextractor.nFeatures: 1200 in the EuRoC
# settings), and one keypoint more; card tests only
N1200_CASES = {
    "n1200": lambda: sizes(10, 8192, 1200),
    "n1200_cluster": lambda: cluster(11, 2048, 1200),
    "n1201": lambda: sizes(12, 8192, 1201),
}
