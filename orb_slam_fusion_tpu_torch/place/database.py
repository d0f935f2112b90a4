"""Keyframe database: a dense BoW matrix and top-k candidate queries.

Counterpart of ``orb_slam_fusion_tpu/place/database.py``: the inverted
file of the reference's KeyFrameDatabase becomes a dense (max_kf x V)
matrix of normalized TF vectors, and a query is one masked IDF-weighted
L1 scoring pass over every row plus a top-k whose ties go to the lower
row, as ``jax.lax.top_k``'s (a stable sort).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import libm
from .tree_vocabulary import TreeVocabulary, bow_vector_tree
from .vocabulary import bow_vector


def compute_bow_vector(vocab, desc: torch.Tensor, valid: torch.Tensor,
                       levels: int = 0) -> torch.Tensor:
    """BoW vector from a flat codebook or a tree (``levels`` its depth)."""
    if isinstance(vocab, TreeVocabulary):
        return bow_vector_tree(vocab, desc, valid, levels)
    return bow_vector(vocab, desc, valid)


def vocab_size(vocab) -> int:
    if isinstance(vocab, TreeVocabulary):
        return vocab.num_words
    return vocab.words.shape[0]


def vocab_device(vocab) -> torch.device:
    return (vocab.node_desc if isinstance(vocab, TreeVocabulary)
            else vocab.words).device


class KeyFrameDatabase:
    """Dense BoW database on the vocabulary's device; accepts a flat
    ``BinaryVocabulary`` or a ``TreeVocabulary`` (its depth as
    ``levels``)."""

    def __init__(self, vocab, max_kf: int, levels: int = 0):
        self.vocab = vocab
        self.levels = levels
        dev = vocab_device(vocab)
        self.bow = torch.zeros((max_kf, vocab_size(vocab)),
                               dtype=torch.float32, device=dev)
        self.present = torch.zeros(max_kf, dtype=torch.bool, device=dev)

    def add(self, kf_id: int, desc: torch.Tensor,
            valid: torch.Tensor) -> None:
        vec = self.compute_bow(desc, valid)
        self.bow = self.bow.clone()
        self.bow[kf_id] = vec
        self.present = self.present.clone()
        self.present[kf_id] = True

    def remove(self, kf_id: int) -> None:
        self.present = self.present.clone()
        self.present[kf_id] = False

    def permute(self, order) -> None:
        """Re-index the rows after a keyframe-table compaction."""
        order = torch.as_tensor(order, dtype=torch.long,
                                device=self.bow.device)
        self.bow = self.bow[order]
        self.present = self.present[order]

    def grow(self, new_max_kf: int) -> None:
        """Pad the row capacity after a keyframe-table growth."""
        K, V = self.bow.shape
        if new_max_kf <= K:
            return
        dev = self.bow.device
        self.bow = torch.cat([self.bow, torch.zeros(
            (new_max_kf - K, V), dtype=torch.float32, device=dev)])
        self.present = torch.cat([self.present, torch.zeros(
            new_max_kf - K, dtype=torch.bool, device=dev)])

    def compute_bow(self, desc: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        return compute_bow_vector(self.vocab, desc, valid, self.levels)

    def query(self, query_vec: torch.Tensor, exclude: torch.Tensor,
              top_k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k keyframes by IDF-weighted L1 similarity; ``exclude``
        (max_kf,) bool. Returns (ids (top_k,) int32, -1 where no candidate
        scores above 0, scores (top_k,))."""
        return _query(self.bow, self.present, query_vec, exclude, top_k)


def _query(bow, present, query_vec, exclude, top_k: int):
    """The reference's ``_query``: IDF from the current document
    frequencies, L1 scores of the IDF-weighted, renormalized vectors."""
    df = torch.sum(((bow > 0) & present[:, None]).to(torch.int32), dim=0)
    n_docs = torch.clamp(torch.sum(present.to(torch.int32)), min=1)
    ratio = n_docs.to(torch.float32) / (1.0 + df.to(torch.float32))
    # the reference's float32 log (XLA:CPU's own, ``utils/libm.py``)
    idf = torch.clamp(libm.log(ratio), min=0.0)
    qw = query_vec * idf
    qn = torch.clamp(torch.sum(torch.abs(qw)), min=1e-9)
    dbw = bow * idf[None, :]
    dbn = torch.clamp(torch.sum(torch.abs(dbw), dim=1, keepdim=True),
                      min=1e-9)
    scores = 1.0 - 0.5 * torch.sum(torch.abs(qw[None, :] / qn - dbw / dbn),
                                   dim=-1)
    scores = torch.where(present & ~exclude, scores,
                         torch.full_like(scores, -1.0))
    vals, ids = torch.sort(scores, descending=True, stable=True)
    vals, ids = vals[:top_k], ids[:top_k].to(torch.int32)
    return torch.where(vals > 0, ids, torch.full_like(ids, -1)), vals
