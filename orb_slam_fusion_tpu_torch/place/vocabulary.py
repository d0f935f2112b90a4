"""Flat binary vocabulary: a seeded codebook of 256-bit words.

Counterpart of ``orb_slam_fusion_tpu/place/vocabulary.py``. The codebook
is drawn by numpy's ``RandomState`` exactly as the reference draws it, and
kept as int32 bit patterns; quantization is one dense (N, V) Hamming
argmin (ties to the lowest word id, as ``jnp.argmin``). Plain PyTorch on
every device: the reference runs it as XLA, not as a Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend.matcher import hamming_distance


class BinaryVocabulary(NamedTuple):
    words: torch.Tensor   # (V, 8) int32 bit patterns


def make_vocabulary(num_words: int = 4096, seed: int = 7,
                    device=None) -> BinaryVocabulary:
    rng = np.random.RandomState(seed)
    w = rng.randint(0, 2 ** 32, size=(num_words, 8),
                    dtype=np.uint64).astype(np.uint32)
    return BinaryVocabulary(words=_words(w, resolve_device(device)))


def _words(w: np.ndarray, device) -> torch.Tensor:
    w = np.ascontiguousarray(w, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32).copy()).to(device)


def argmin_first(d: torch.Tensor) -> torch.Tensor:
    """Row-wise argmin with ties to the lowest column (int64), on every
    backend."""
    best = torch.amin(d, dim=-1, keepdim=True)
    cols = torch.arange(d.shape[-1], device=d.device)
    return torch.amin(torch.where(d == best, cols,
                                  torch.full_like(cols, d.shape[-1])),
                      dim=-1)


def quantize(vocab: BinaryVocabulary, desc: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """(N, 8) descriptors -> (N,) int32 word ids (-1 for invalid slots)."""
    wid = argmin_first(hamming_distance(desc, vocab.words)).to(torch.int32)
    return torch.where(valid, wid, torch.full_like(wid, -1))


def bow_vector(vocab: BinaryVocabulary, desc: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """L1-normalized term-frequency vector (V,) for one frame (the
    database applies the IDF weights when it scores)."""
    V = vocab.words.shape[0]
    wid = quantize(vocab, desc, valid)
    counts = torch.zeros(V, dtype=torch.float32, device=desc.device)
    counts.index_add_(0, torch.clamp(wid, 0, V - 1).long(),
                      valid.to(torch.float32))
    total = torch.clamp(torch.sum(counts), min=1.0)
    return counts / total


def l1_score(v: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of one vector against a batch:
    1 - 0.5 * |v - w|_1, (K,) scores in [0, 1]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v[None, :] - ws), dim=-1)


# -- persistence (the reference's small self-describing binary format and
# its text import) ----------------------------------------------------------

_VOCAB_MAGIC = b"OSFV"
_VOCAB_VERSION = 1


def save_vocabulary_binary(path: str, vocab: BinaryVocabulary) -> None:
    words = vocab.words.cpu().numpy().view(np.uint32)
    with open(path, "wb") as f:
        f.write(_VOCAB_MAGIC)
        np.array([_VOCAB_VERSION, words.shape[0]], np.uint32).tofile(f)
        words.tofile(f)


def load_vocabulary_binary(path: str, device=None) -> BinaryVocabulary:
    with open(path, "rb") as f:
        if f.read(4) != _VOCAB_MAGIC:
            raise ValueError(f"{path}: not an OSF vocabulary file")
        version, n = np.fromfile(f, np.uint32, 2)
        if version != _VOCAB_VERSION:
            raise ValueError(f"{path}: unsupported vocabulary version "
                             f"{version}")
        words = np.fromfile(f, np.uint32, int(n) * 8).reshape(int(n), 8)
    return BinaryVocabulary(words=_words(words, resolve_device(device)))


def load_vocabulary_text(path: str, device=None) -> BinaryVocabulary:
    """One word per line, 8 uint32 values (``#`` comments)."""
    rows = np.loadtxt(path, dtype=np.uint64, comments="#", ndmin=2)
    if rows.shape[1] != 8:
        raise ValueError(f"{path}: expected 8 columns, got {rows.shape[1]}")
    return BinaryVocabulary(words=_words(rows.astype(np.uint32),
                                         resolve_device(device)))
