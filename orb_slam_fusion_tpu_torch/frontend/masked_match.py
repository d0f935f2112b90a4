"""Fused masked Hamming match: the port of the reference's Pallas kernel.

Counterpart of ``orb_slam_fusion_tpu/frontend/pallas_match.py``
(``masked_match_pallas``). For each map point it finds, over all keypoints
inside its pixel window (and octave window when octaves are given), the
best and second-best Hamming distance, without materialising the (M, N)
distance matrix. The kernel is ``csrc/masked_match.cu`` (CUDA C++ for
sm_90a), built by ``kernels/build.py`` and called through ctypes: each
block keeps the keypoints in shared memory, binned into a grid of cells,
and a row visits only the cells its window overlaps, so the popcounts are
spent on the pairs the window passes.

``masked_match`` sends a CUDA tensor to the kernel, always; a CPU tensor
goes to ``masked_match_plain``, the plain PyTorch version the tests hold
against the reference and ``chip_smoke.py`` holds the kernel against.
Masks are folded into geometry exactly as the reference folds them: an
invalid map point gets radius -1 (empty window), an invalid keypoint sits
at (1e9, 1e9), and a missing map octave is -1e4 (gate off).

``fused_window`` selects the window's rounding: by default
``du*du + dv*dv`` with each product rounded (the Pallas kernel's order);
with it, ``fma(dv, dv, du*du)``, the single rounding XLA:CPU gives the
reference's dense ``sum((uv - kp)**2, -1)`` (the distributed tracker's
window, ``parallel/dist_track.py``).

``launches`` counts kernel launches made through ``masked_match``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.fused import within_fused
from .matcher import BIG, hamming_distance_rows, masked_min2

launches = 0


def _fold(pred_uv, mp_valid, radius, kp_uv, kp_valid, mp_octave,
          kp_octave):
    """(uvr (M,4), kp_uvo (N,4)) float32 with the masks folded in."""
    M, N = pred_uv.shape[0], kp_uv.shape[0]
    f32 = torch.float32
    r = torch.as_tensor(radius, dtype=f32, device=pred_uv.device)
    r_eff = torch.where(mp_valid, r.expand(M), torch.full_like(r.expand(M),
                                                               -1.0))
    if mp_octave is None:
        mp_oct = torch.full((M,), -1e4, dtype=f32, device=pred_uv.device)
    else:
        mp_oct = mp_octave.to(f32)
    uvr = torch.stack([pred_uv[:, 0].to(f32), pred_uv[:, 1].to(f32), r_eff,
                       mp_oct], dim=1)
    kp_oct = (torch.zeros(N, dtype=f32, device=kp_uv.device)
              if kp_octave is None else kp_octave.to(f32))
    far = torch.full_like(kp_uv[:, 0], 1e9, dtype=f32)
    kp_uvo = torch.stack([
        torch.where(kp_valid, kp_uv[:, 0].to(f32), far),
        torch.where(kp_valid, kp_uv[:, 1].to(f32), far),
        kp_oct, torch.zeros_like(kp_oct)], dim=1)
    return uvr, kp_uvo


def window_mask(uvr: torch.Tensor, kp_uvo: torch.Tensor,
                fused_window: bool = False) -> torch.Tensor:
    """(M, N) bool: the pairs the pixel window and the octave gate pass."""
    du = uvr[:, 0:1] - kp_uvo[None, :, 0]
    dv = uvr[:, 1:2] - kp_uvo[None, :, 1]
    r = uvr[:, 2:3]
    r2 = r * torch.abs(r)
    ok = (within_fused(du, dv, r2) if fused_window
          else du * du + dv * dv <= r2)
    mp_oct = uvr[:, 3:4]
    return ok & ((torch.abs(mp_oct - kp_uvo[None, :, 2]) <= 1.5)
                 | (mp_oct < 0.0))


def masked_match_folded_plain(uvr: torch.Tensor, mp_desc: torch.Tensor,
                              kp_uvo: torch.Tensor, kp_desc: torch.Tensor,
                              fused_window: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """What the kernel computes, on folded inputs, in plain PyTorch: the
    Hamming distances of the pairs the window passes (the others BIG),
    then the masked best and second best."""
    mask = window_mask(uvr, kp_uvo, fused_window)
    i, j = torch.nonzero(mask, as_tuple=True)
    dist = torch.full(mask.shape, BIG, dtype=torch.int32, device=mask.device)
    dist[i, j] = hamming_distance_rows(mp_desc[i], kp_desc[j])
    return masked_min2(dist, mask)


def masked_match_plain(pred_uv, mp_desc, mp_valid, radius, kp_uv, kp_desc,
                       kp_valid, mp_octave=None, kp_octave=None,
                       fused_window: bool = False):
    """Plain PyTorch version of ``masked_match`` (any device)."""
    uvr, kp_uvo = _fold(pred_uv, mp_valid, radius, kp_uv, kp_valid,
                        mp_octave, kp_octave)
    return masked_match_folded_plain(uvr, mp_desc.to(torch.int32), kp_uvo,
                                     kp_desc.to(torch.int32), fused_window)


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def kernel_flags(use_octave: bool, fused_window: bool = False) -> int:
    """The kernel's mode word: bit 0 the octave gate, bit 1 the fused
    window rounding."""
    return int(bool(use_octave)) | (int(bool(fused_window)) << 1)


def masked_match_cuda(uvr: torch.Tensor, mp_desc: torch.Tensor,
                      kp_uvo: torch.Tensor, kp_desc: torch.Tensor,
                      use_octave: bool, fused_window: bool = False):
    """Launch the kernel on folded CUDA inputs; returns 3 x (M,) int32,
    what ``masked_match_folded_plain`` returns. With ``use_octave`` False
    the kernel skips the octave gate, which the plain version passes
    anyway when ``uvr[:, 3] < 0`` (``_fold`` sets -1e4 there)."""
    global launches
    from ..kernels.build import launcher

    dev = uvr.device
    if dev.type != "cuda":
        raise ValueError(f"masked_match_cuda needs CUDA tensors, got {dev}")
    M, N = uvr.shape[0], kp_uvo.shape[0]
    if N < 1:
        raise ValueError("masked_match needs at least one keypoint")
    _check("uvr", uvr, (M, 4), torch.float32, dev)
    _check("mp_desc", mp_desc, (M, 8), torch.int32, dev)
    _check("kp_uvo", kp_uvo, (N, 4), torch.float32, dev)
    _check("kp_desc", kp_desc, (N, 8), torch.int32, dev)
    for name, t in (("uvr", uvr), ("mp_desc", mp_desc), ("kp_uvo", kp_uvo),
                    ("kp_desc", kp_desc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as "
                             f"16-byte vectors)")
    out = [torch.empty(M, dtype=torch.int32, device=dev) for _ in range(3)]
    fn = launcher("masked_match")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(uvr.data_ptr(), mp_desc.data_ptr(), kp_uvo.data_ptr(),
                kp_desc.data_ptr(), M, N, kernel_flags(use_octave,
                                                       fused_window),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"masked_match kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return tuple(out)


def masked_match(pred_uv: torch.Tensor, mp_desc: torch.Tensor,
                 mp_valid: torch.Tensor, radius, kp_uv: torch.Tensor,
                 kp_desc: torch.Tensor, kp_valid: torch.Tensor,
                 mp_octave: Optional[torch.Tensor] = None,
                 kp_octave: Optional[torch.Tensor] = None,
                 fused_window: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (best_idx (M,), best (M,), second (M,)) int32, BIG where
    masked; pairs with |octave difference| > 1 are masked when octaves are
    given. CUDA tensors run the kernel, CPU tensors the plain version."""
    M, N = pred_uv.shape[0], kp_uv.shape[0]
    dev = pred_uv.device
    _check("pred_uv", pred_uv, (M, 2), torch.float32, dev)
    _check("mp_desc", mp_desc, (M, 8), torch.int32, dev)
    _check("mp_valid", mp_valid, (M,), torch.bool, dev)
    _check("kp_uv", kp_uv, (N, 2), torch.float32, dev)
    _check("kp_desc", kp_desc, (N, 8), torch.int32, dev)
    _check("kp_valid", kp_valid, (N,), torch.bool, dev)
    if (mp_octave is None) != (kp_octave is None):
        raise ValueError("give both octaves or neither")
    if dev.type == "cpu":
        return masked_match_plain(pred_uv, mp_desc, mp_valid, radius, kp_uv,
                                  kp_desc, kp_valid, mp_octave, kp_octave,
                                  fused_window)
    uvr, kp_uvo = _fold(pred_uv, mp_valid, radius, kp_uv, kp_valid,
                        mp_octave, kp_octave)
    return masked_match_cuda(uvr, mp_desc, kp_uvo, kp_desc,
                             use_octave=mp_octave is not None,
                             fused_window=fused_window)
