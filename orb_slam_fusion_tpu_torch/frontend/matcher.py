"""Descriptor matching: Hamming distances and masked best/second search.

Counterpart of ``orb_slam_fusion_tpu/frontend/matcher.py`` (thresholds
TH_LOW=50, TH_HIGH=100, ratio 0.9). Descriptors are int32 bit patterns;
torch has no popcount and no logical right shift on 32-bit words, so the
popcount is SWAR arithmetic written to stay right under arithmetic shifts.
These are plain PyTorch on every device: the dense matches here were XLA
work in the reference, not its Pallas kernel (that one is
``masked_match.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.fused import within_fused

TH_LOW = 50
TH_HIGH = 100
RATIO = 0.9
BIG = 1 << 14  # sentinel distance for masked-out pairs (> 256)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR).

    Every mask keeps the bits that an arithmetic (sign-filling) shift would
    spoil out of the result, and after the nibble step all values are
    non-negative, so ``>>`` behaves as a logical shift from there on.
    """
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_distance(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N,8) x (M,8) int32 -> (N,M) int32 Hamming distances (word by word,
    so the largest temporary is one (N, M) plane)."""
    out = torch.zeros((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                      device=d1.device)
    for w in range(d1.shape[1]):
        out += popcount32(d1[:, w, None] ^ d2[None, :, w])
    return out


def hamming_distance_rows(d1: torch.Tensor, d2: torch.Tensor
                          ) -> torch.Tensor:
    """Paired (N,8) x (N,8) -> (N,) int32 Hamming distances."""
    return torch.sum(popcount32(d1 ^ d2), dim=-1, dtype=torch.int32)


def masked_min2(dist: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row (best_idx, best, second) over masked columns, BIG where
    masked; the lowest index wins ties and ``second`` excludes only the
    best column, so a tied duplicate gives second == best."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    # argmin with the lowest index on ties, on every backend
    best = torch.amin(d, dim=1)
    cols = torch.arange(d.shape[1], device=d.device, dtype=torch.int32)
    big_col = torch.full_like(cols, d.shape[1])
    best_idx = torch.amin(torch.where(d == best[:, None], cols, big_col),
                          dim=1)
    d2 = torch.where(cols[None, :] == best_idx[:, None],
                     torch.full_like(d, BIG), d)
    second = torch.amin(d2, dim=1)
    return best_idx, best, second


def match_mutual(desc1: torch.Tensor, valid1: torch.Tensor,
                 desc2: torch.Tensor, valid2: torch.Tensor,
                 max_dist: int = TH_LOW, ratio: float = RATIO
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual-best brute-force matching with ratio test.
    Returns (match_idx (N,) into desc2 or -1, ok (N,))."""
    dist = hamming_distance(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :]
    idx12, best12, second12 = masked_min2(dist, mask)
    idx21, _, _ = masked_min2(dist.T, mask.T)
    mutual = idx21[idx12.long()] == torch.arange(
        desc1.shape[0], device=desc1.device, dtype=torch.int32)
    ok = (mutual & (best12 <= max_dist)
          & (best12.to(torch.float32) <= ratio * second12.to(torch.float32))
          & valid1)
    return torch.where(ok, idx12, torch.full_like(idx12, -1)), ok


def match_masked(desc1: torch.Tensor, desc2: torch.Tensor,
                 pair_mask: torch.Tensor, max_dist: int = TH_HIGH,
                 ratio: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best match per row under an arbitrary (N, M) pair mask."""
    idx, best, second = masked_min2(hamming_distance(desc1, desc2),
                                    pair_mask)
    ok = (best <= max_dist) & (
        best.to(torch.float32) <= ratio * second.to(torch.float32))
    return torch.where(ok, idx, torch.full_like(idx, -1)), ok


def search_by_projection(pred_uv, mp_desc, mp_valid, mp_octave, kp_uv,
                         kp_desc, kp_valid, kp_octave, radius,
                         max_dist: int = TH_HIGH, ratio: float = RATIO,
                         octave_window: int = 1, fused: bool = False):
    """Projection-window search as a masked dense match.
    Returns (match_idx (N,), ok (N,)). ``fused`` rounds the window as the
    reference's jitted callers do (``fma(dv, dv, du*du)``, ROADMAP C11);
    without it, as its eager callers do (each square and the sum)."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=pred_uv.device)
    if r.ndim == 0:
        r = r.expand(pred_uv.shape[0])
    diff = pred_uv[:, None, :] - kp_uv[None, :, :]
    r2 = r[:, None] ** 2
    within = (within_fused(diff[..., 0], diff[..., 1], r2) if fused
              else torch.sum(diff ** 2, dim=-1) <= r2)
    oct_ok = torch.abs(mp_octave[:, None] - kp_octave[None, :]) \
        <= octave_window
    mask = within & oct_ok & mp_valid[:, None] & kp_valid[None, :]
    return match_masked(mp_desc, kp_desc, mask, max_dist, ratio)


def rotation_consistency_mask(angle1: torch.Tensor, angle2: torch.Tensor,
                              match_idx: torch.Tensor, ok: torch.Tensor,
                              n_bins: int = 30, keep_bins: int = 3
                              ) -> torch.Tensor:
    """Rotation-histogram filter (reference ORBmatcher::ComputeThreeMaxima,
    HISTO_LENGTH = 30): keep the matches whose keypoint-angle difference
    falls in the ``keep_bins`` most popular bins (ties to the lower bin,
    as ``lax.top_k``)."""
    a2 = angle2[torch.clamp(match_idx, 0, angle2.shape[0] - 1).long()]
    da = angle1 - torch.where(ok, a2, torch.zeros_like(a2))
    two_pi = torch.tensor(2.0 * np.pi, dtype=da.dtype, device=da.device)
    # jnp.mod: the remainder takes the divisor's sign
    rem = torch.fmod(da, two_pi)
    da = torch.where((rem != 0) & (rem < 0), rem + two_pi, rem)
    n = torch.tensor(float(n_bins), dtype=da.dtype, device=da.device)
    bins = torch.clamp((da / two_pi * n).to(torch.int32), 0, n_bins - 1)
    hist = torch.zeros(n_bins, dtype=torch.int32, device=da.device)
    hist.index_add_(0, bins.long(), ok.to(torch.int32))
    top = torch.sort(hist, descending=True, stable=True)[1][:keep_bins]
    in_top = torch.any(bins[:, None].long() == top[None, :], dim=1)
    return ok & in_top


def search_by_bow(node1: torch.Tensor, desc1: torch.Tensor,
                  valid1: torch.Tensor, node2: torch.Tensor,
                  desc2: torch.Tensor, valid2: torch.Tensor,
                  max_dist: int = TH_LOW, ratio: float = RATIO
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-index-constrained matching (reference ORBmatcher::
    SearchByBoW): features are compared only when they descend through
    the same vocabulary node at the direct-index level (node -1 never
    matches). Returns (match_idx (N,) into desc2 or -1, ok (N,))."""
    same = (node1[:, None] == node2[None, :]) & (node1 >= 0)[:, None]
    mask = same & valid1[:, None] & valid2[None, :]
    return match_masked(desc1, desc2, mask, max_dist, ratio)
