"""PyTorch port parity: descriptor matching and the masked-match kernel's
plain version.

``masked_match_plain`` is what the CUDA kernel is held against on the card,
so here it is held bit-exact against the reference's Pallas kernel (in
interpret mode, as the reference's own tests run it on the CPU) and
against ``matcher.masked_min2`` with explicit masks: ties, all-masked
rows, the octave gate on and off, and the adversarial cases of
``torch_match_cases.py`` (window and cell borders, clusters, special
radii and centres, far keypoints, ties across cells, N = 1, M = 1, N beyond
the kernel's shared-memory budget). The CUDA launch itself is tested on
the card (tests/test_torch_cuda.py), on the same cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_fusion_tpu.frontend import matcher as jm
from orb_slam_fusion_tpu.frontend.pallas_match import masked_match_pallas
from orb_slam_fusion_tpu_torch.frontend import masked_match as tmm
from orb_slam_fusion_tpu_torch.frontend import matcher as tm
from orb_slam_fusion_tpu_torch.map.convert import desc_to_torch

import test_torch_helpers as h
import torch_match_cases as cases

torch.set_num_threads(1)


def _case(seed, M=700, N=256):
    """Planted exact matches near their map points, duplicated keypoints
    (ties), invalid rows/columns, negative radii (empty windows) and a
    block of rows with no keypoint in reach (all masked)."""
    rng = np.random.RandomState(seed)
    pred_uv = rng.uniform(0, 470, (M, 2)).astype(np.float32)
    kp_uv = rng.uniform(0, 470, (N, 2)).astype(np.float32)
    mp_desc = rng.randint(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(
        np.uint32)
    kp_desc = rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(
        np.uint32)
    n_plant, n_dup = min(120, N // 2), min(40, N // 4)
    rows = rng.choice(M, n_plant, replace=False)
    cols = rng.choice(N, n_plant, replace=False)
    kp_desc[cols] = mp_desc[rows]
    kp_uv[cols] = pred_uv[rows] + rng.randn(n_plant, 2).astype(
        np.float32) * 2
    dst = rng.choice(np.setdiff1d(np.arange(N), cols), n_dup, replace=False)
    kp_desc[dst] = kp_desc[cols[:n_dup]]          # tied duplicates
    kp_uv[dst] = kp_uv[cols[:n_dup]] + 0.5
    pred_uv[:30] = 5000.0                         # nothing in reach
    radius = rng.uniform(5, 40, M).astype(np.float32)
    radius[30:60] = -1.0
    return dict(
        pred_uv=pred_uv, mp_desc=mp_desc, mp_valid=rng.rand(M) > 0.1,
        radius=radius, kp_uv=kp_uv, kp_desc=kp_desc,
        kp_valid=rng.rand(N) > 0.1,
        mp_octave=rng.randint(-1, 8, M).astype(np.int32),
        kp_octave=rng.randint(0, 8, N).astype(np.int32))


def _torch_args(c, octave):
    t = lambda k: torch.from_numpy(np.array(c[k]))     # noqa: E731
    return ((t("pred_uv"), desc_to_torch(c["mp_desc"], "cpu"),
             t("mp_valid"), t("radius"), t("kp_uv"),
             desc_to_torch(c["kp_desc"], "cpu"), t("kp_valid")),
            dict(mp_octave=t("mp_octave") if octave else None,
                 kp_octave=t("kp_octave") if octave else None))


@pytest.mark.parametrize("octave", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel_bit_exact(seed, octave):
    """(best_idx, best, second) bit-exact against masked_match_pallas in
    interpret mode, through the CPU dispatch of the public wrapper."""
    c = _case(seed)
    ref = masked_match_pallas(
        *(jnp.asarray(c[k]) for k in ("pred_uv", "mp_desc", "mp_valid",
                                      "radius", "kp_uv", "kp_desc",
                                      "kp_valid")),
        mp_octave=jnp.asarray(c["mp_octave"]) if octave else None,
        kp_octave=jnp.asarray(c["kp_octave"]) if octave else None,
        interpret=True)
    args, kw = _torch_args(c, octave)
    before = tmm.launches
    out = tmm.masked_match(*args, **kw)
    assert tmm.launches == before        # CPU tensors never count a launch
    for r, o, name in zip(ref, out, ("best_idx", "best", "second")):
        np.testing.assert_array_equal(np.asarray(r), o.numpy(),
                                      err_msg=name)
    best, second = out[1].numpy(), out[2].numpy()
    assert (best == tm.BIG).sum() >= 60                  # all-masked rows
    assert ((second == best) & (best < tm.BIG)).any()    # ties seen
    assert (best == 0).sum() >= 30                       # planted matches


@pytest.mark.parametrize("octave", [False, True])
@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_plain_matches_pallas_on_adversarial_cases(name, octave):
    """The yardstick pinned at the edges: bit-exact against the Pallas
    kernel in interpret mode on every adversarial case."""
    c = cases.CASES[name]()
    ref = masked_match_pallas(
        *(jnp.asarray(c[k]) for k in ("pred_uv", "mp_desc", "mp_valid",
                                      "radius", "kp_uv", "kp_desc",
                                      "kp_valid")),
        mp_octave=jnp.asarray(c["mp_octave"]) if octave else None,
        kp_octave=jnp.asarray(c["kp_octave"]) if octave else None,
        interpret=True)
    args, kw = _torch_args(c, octave)
    out = tmm.masked_match(*args, **kw)
    for r, o, what in zip(ref, out, ("best_idx", "best", "second")):
        np.testing.assert_array_equal(np.asarray(r), o.numpy(),
                                      err_msg=what)


@pytest.mark.parametrize("octave", [False, True])
def test_plain_matches_masked_min2(octave):
    """Bit-exact against the reference's dense hamming + masked_min2 with
    the masks written out (the XLA path of fused_frame_update)."""
    c = _case(3)
    d2 = np.sum((c["pred_uv"][:, None] - c["kp_uv"][None]) ** 2, -1)
    mask = (d2 <= c["radius"][:, None] ** 2) & (c["radius"][:, None] >= 0) \
        & c["mp_valid"][:, None] & c["kp_valid"][None]
    if octave:
        mask &= (np.abs(c["mp_octave"][:, None] - c["kp_octave"][None]) <= 1) \
            | (c["mp_octave"][:, None] < 0)
    dist = jm.hamming_distance(jnp.asarray(c["mp_desc"]),
                               jnp.asarray(c["kp_desc"]))
    ref = jm.masked_min2(dist, jnp.asarray(mask))
    args, kw = _torch_args(c, octave)
    out = tmm.masked_match_plain(*args, **kw)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())


def test_hamming_and_mutual_match():
    """popcount / hamming / masked_min2 / match_mutual / match_masked /
    search_by_projection: bit-exact against the reference."""
    rng = np.random.RandomState(4)
    d1 = rng.randint(0, 2 ** 32, (90, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.randint(0, 2 ** 32, (70, 8), dtype=np.uint64).astype(np.uint32)
    d1[0] = 0xFFFFFFFF
    d2[0] = 0
    d2[1:31] = d1[1:31]
    d2[31:41] = d1[1:11]                          # ties for mutual check
    d2[1:31, 3] ^= np.uint32(1 << 31)             # sign-bit flips
    v1, v2 = rng.rand(90) > 0.1, rng.rand(70) > 0.1
    t1, t2 = desc_to_torch(d1, "cpu"), desc_to_torch(d2, "cpu")
    dj = jm.hamming_distance(jnp.asarray(d1), jnp.asarray(d2))
    np.testing.assert_array_equal(np.asarray(dj),
                                  tm.hamming_distance(t1, t2).numpy())
    np.testing.assert_array_equal(
        np.asarray(jm.hamming_distance_rows(jnp.asarray(d1[:70]),
                                            jnp.asarray(d2))),
        tm.hamming_distance_rows(t1[:70], t2).numpy())
    for a, b in zip(jm.match_mutual(jnp.asarray(d1), jnp.asarray(v1),
                                    jnp.asarray(d2), jnp.asarray(v2)),
                    tm.match_mutual(t1, torch.from_numpy(v1), t2,
                                    torch.from_numpy(v2))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    uv1 = rng.uniform(0, 100, (90, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 100, (70, 2)).astype(np.float32)
    o1 = rng.randint(0, 4, 90).astype(np.int32)
    o2 = rng.randint(0, 4, 70).astype(np.int32)
    ref = jm.search_by_projection(
        jnp.asarray(uv1), jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(o1),
        jnp.asarray(uv2), jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(o2),
        radius=30.0, max_dist=140)
    out = tm.search_by_projection(
        torch.from_numpy(uv1), t1, torch.from_numpy(v1), torch.from_numpy(o1),
        torch.from_numpy(uv2), t2, torch.from_numpy(v2), torch.from_numpy(o2),
        radius=30.0, max_dist=140)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(ref[1]).sum()) > 0


def test_wrapper_rejects_bad_inputs():
    """The wrapper checks dtype, shape, device and octave pairing before
    dispatch, on the CPU as on the card."""
    c = _case(5, M=32, N=16)
    args, kw = _torch_args(c, True)
    bad_dtype = list(args)
    bad_dtype[1] = args[1].to(torch.int64)
    with pytest.raises(TypeError):
        tmm.masked_match(*bad_dtype, **kw)
    bad_shape = list(args)
    bad_shape[4] = args[4][:, :1].contiguous()
    with pytest.raises(ValueError):
        tmm.masked_match(*bad_shape, **kw)
    bad_contig = list(args)
    bad_contig[0] = torch.from_numpy(
        np.ascontiguousarray(c["pred_uv"].T)).T
    with pytest.raises(ValueError):
        tmm.masked_match(*bad_contig, **kw)
    with pytest.raises(ValueError):
        tmm.masked_match(*args, mp_octave=kw["mp_octave"], kp_octave=None)
    with pytest.raises(ValueError):
        uvr, kp_uvo = tmm._fold(args[0], args[2], args[3], args[4], args[6],
                                None, None)
        tmm.masked_match_cuda(uvr, args[1], kp_uvo, args[5], False)


@pytest.mark.parametrize("fused_inside", [True, False],
                         ids=["inside-fused", "inside-term-by-term"])
def test_search_by_projection_window_edge(fused_inside):
    """The dense projection search at the window's edge (ROADMAP C11):
    with ``fused`` it rounds as the reference's search does inside a jitted
    program (the tracking step's and mapping's callers), without it as the
    reference's eager callers (loop closing) do."""
    import jax
    mp_pos, desc, kp = h.window_edge_scene(fused_inside)
    uv, n = mp_pos[:, :2].copy(), len(mp_pos)
    octave = np.zeros(n, np.int32)
    args = (uv, desc, np.ones(n, bool), octave, kp, desc, np.ones(n, bool),
            octave)
    jargs = [jnp.asarray(a) for a in args] + [15.0]
    targs = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                              else a) for a in args] + [15.0]
    _, ok_jit = jax.jit(jm.search_by_projection)(*jargs)
    _, ok_eager = jm.search_by_projection(*jargs)
    _, ok_fused = tm.search_by_projection(*targs, fused=True)
    _, ok_plain = tm.search_by_projection(*targs)
    assert int(np.asarray(ok_jit).sum()) == (n if fused_inside else 0)
    assert int(np.asarray(ok_eager).sum()) == (0 if fused_inside else n)
    np.testing.assert_array_equal(np.asarray(ok_jit), ok_fused.numpy())
    np.testing.assert_array_equal(np.asarray(ok_eager), ok_plain.numpy())


@pytest.mark.parametrize("form", ["diff", "ratio", "three"])
def test_sum_sq_f32_is_xlas_fused_sum(form):
    """``utils.fused.sum_sq_f32`` against the reference's sums of squares
    compiled by XLA:CPU, in the forms the port's gates use (C11): the PnP
    and projection residual ``sum((a - b)**2)``, the two-view and mapping
    parallax-check residual ``sum((X/z - r)**2)`` and the mapping normals'
    ``sum(x**2)`` over 3; every value bit-exact."""
    import jax
    from orb_slam_fusion_tpu_torch.utils.fused import sum_sq_f32
    rng = np.random.RandomState(3)
    x = [rng.randn(1 << 15).astype(np.float32) * 3 for _ in range(5)]
    j = [jnp.asarray(a) for a in x]
    t = [torch.from_numpy(a) for a in x]
    if form == "diff":
        want = jax.jit(lambda a, b, c, d: jnp.sum(
            (jnp.stack([a, b], -1) - jnp.stack([c, d], -1)) ** 2, -1))(*j[:4])
        got = sum_sq_f32(torch.stack(t[:2], -1) - torch.stack(t[2:4], -1))
    elif form == "ratio":
        want = jax.jit(lambda a, b, z, c, d: jnp.sum(
            (jnp.stack([a, b], -1) / jnp.maximum(jnp.abs(z)[..., None] + 1,
                                                 1e-9)
             - jnp.stack([c, d], -1)) ** 2, -1))(*j)
        got = sum_sq_f32(torch.stack(t[:2], -1) / torch.clamp(
            torch.abs(t[2])[..., None] + 1, min=1e-9)
            - torch.stack(t[3:5], -1))
    else:
        want = jax.jit(lambda a, b, c: jnp.sum(
            jnp.stack([a, b, c], -1) ** 2, -1))(*j[:3])
        got = sum_sq_f32(torch.stack(t[:3], -1))
    np.testing.assert_array_equal(np.asarray(want).view(np.int32),
                                  got.numpy().view(np.int32))
