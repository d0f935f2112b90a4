"""Hierarchical binary vocabulary: the DBoW2 tree as a batched descent.

Counterpart of ``orb_slam_fusion_tpu/place/tree_vocabulary.py``. The tree
is flattened into device tensors (``node_desc`` as int32 bit patterns,
``children_idx`` -1 padded, ``word_id`` -1 on inner nodes, per-word idf
weights and the node of each word); ``quantize_tree`` descends all
descriptors in lock step, ``levels`` rounds of gather + Hamming + argmin
(ties to the first child, as ``jnp.argmin``). Training
(``train_vocabulary``, hierarchical binary k-medians) is the reference's
host numpy, copied; the loaders read DBoW2's text format (with the Python
parser only) and the fork's packed binary format.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend.matcher import popcount32
from .vocabulary import argmin_first


class TreeVocabulary(NamedTuple):
    node_desc: torch.Tensor     # (num_nodes, 8) int32 centroid bits
    children_idx: torch.Tensor  # (num_nodes, K) int32, -1 padded
    word_id: torch.Tensor       # (num_nodes,) int32, -1 for inner nodes
    word_weight: torch.Tensor   # (num_words,) float32 idf weights
    word_node: torch.Tensor     # (num_words,) int32 node id of each word

    @property
    def num_words(self) -> int:
        return self.word_weight.shape[0]

    @property
    def branching(self) -> int:
        return self.children_idx.shape[1]

    def depth(self) -> int:
        """Tree depth L (host side; walks children_idx)."""
        ch = self.children_idx.cpu().numpy()
        depth, frontier = 0, np.array([0])
        while True:
            nxt = ch[frontier].ravel()
            nxt = nxt[nxt >= 0]
            if nxt.size == 0:
                return depth
            frontier = nxt
            depth += 1


def quantize_tree(vocab: TreeVocabulary, desc: torch.Tensor,
                  valid: torch.Tensor, levels: int,
                  direct_level: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 8) descriptors -> (word id, direct-index node id), int32, -1 on
    invalid slots. ``direct_level`` counts from the root (default
    ``max(levels - 4, 1)``, DBoW2's levelsup = 4)."""
    if direct_level is None:
        direct_level = max(levels - 4, 1)
    n = desc.shape[0]
    dev = desc.device
    node = torch.zeros(n, dtype=torch.long, device=dev)
    direct = node
    for level in range(levels):
        ch = vocab.children_idx[node].long()                   # (N, K)
        ch_desc = vocab.node_desc[torch.clamp(ch, min=0)]      # (N, K, 8)
        dist = torch.sum(popcount32(desc[:, None, :] ^ ch_desc), dim=-1)
        dist = torch.where(ch >= 0, dist, torch.full_like(dist, 1 << 14))
        sel = argmin_first(dist)
        nxt = torch.gather(ch, 1, sel[:, None])[:, 0]
        node = torch.where(nxt >= 0, nxt, node)                # leaf: stay
        if level + 1 == direct_level:
            direct = node
    word = vocab.word_id[node]
    direct = direct.to(torch.int32)
    return (torch.where(valid, word, torch.full_like(word, -1)),
            torch.where(valid, direct, torch.full_like(direct, -1)))


def _bow_from_words(word: torch.Tensor, valid: torch.Tensor,
                    word_weight: torch.Tensor) -> torch.Tensor:
    V = word_weight.shape[0]
    ok = valid & (word >= 0)
    w = torch.clamp(word, 0, V - 1).long()
    vec = torch.zeros(V, dtype=torch.float32, device=word.device)
    # every addend of one word is that word's weight, so the sum does not
    # depend on the scatter's order
    vec.index_add_(0, w, torch.where(ok, word_weight[w],
                                     torch.zeros_like(word_weight[w])))
    total = torch.clamp(torch.sum(vec), min=1e-9)
    return vec / total


def bow_vector_tree(vocab: TreeVocabulary, desc: torch.Tensor,
                    valid: torch.Tensor, levels: int) -> torch.Tensor:
    """L1-normalized TF-IDF vector (num_words,) (DBoW2 TF_IDF)."""
    word, _ = quantize_tree(vocab, desc, valid, levels)
    return _bow_from_words(word, valid, vocab.word_weight)


# ---------------------------------------------------------------------------
# training: hierarchical binary k-medians (host tooling, the reference's
# numpy)
# ---------------------------------------------------------------------------

def _kmedians_binary(desc: np.ndarray, k: int, rng: np.random.RandomState,
                     iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Binary k-medians (bitwise majority-vote centroids). Returns
    (centroids (k', 8) uint32, assignment (N,)) with k' <= k."""
    n = desc.shape[0]
    k = min(k, n)
    centers = desc[rng.choice(n, k, replace=False)]
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)      # (N, 256)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        cbits = np.unpackbits(centers.view(np.uint8), axis=-1)
        dot = (2.0 * bits - 1.0) @ (2.0 * cbits - 1.0).T
        new_assign = np.argmax(dot, axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for c in range(centers.shape[0]):
            members = bits[assign == c]
            if members.shape[0] == 0:
                continue
            maj = (members.mean(axis=0) >= 0.5).astype(np.uint8)
            centers[c] = np.packbits(maj).view(np.uint32)
    used = np.unique(assign)
    remap = -np.ones(centers.shape[0], np.int64)
    remap[used] = np.arange(used.size)
    return centers[used], remap[assign]


def _tensors(node_desc, children_idx, word_id, word_weight, word_node,
             device) -> TreeVocabulary:
    nd = np.ascontiguousarray(node_desc, np.uint32).view(np.int32)
    return TreeVocabulary(
        node_desc=torch.from_numpy(nd.copy()).to(device),
        children_idx=torch.from_numpy(
            np.asarray(children_idx, np.int32)).to(device),
        word_id=torch.from_numpy(np.asarray(word_id, np.int32)).to(device),
        word_weight=torch.from_numpy(
            np.asarray(word_weight, np.float32)).to(device),
        word_node=torch.from_numpy(
            np.asarray(word_node, np.int32)).to(device))


def train_vocabulary(desc: np.ndarray, k: int = 10, levels: int = 3,
                     seed: int = 0, device=None) -> TreeVocabulary:
    """A k^levels-word tree from (N, 8) uint32 descriptors (DBoW2
    ``create``'s hierarchical k-medians); idf = log(N / leaf size)."""
    dev = resolve_device(device)
    desc = np.ascontiguousarray(desc, np.uint32)
    rng = np.random.RandomState(seed)
    nodes_desc = [np.zeros(8, np.uint32)]                   # root
    children: List[List[int]] = [[]]

    def split(node_id: int, members: np.ndarray, level: int) -> None:
        if level == levels or members.shape[0] <= 1:
            return
        centers, assign = _kmedians_binary(members, k, rng)
        for c in range(centers.shape[0]):
            cid = len(nodes_desc)
            nodes_desc.append(centers[c])
            children.append([])
            children[node_id].append(cid)
            split(cid, members[assign == c], level + 1)

    split(0, desc, 0)
    num_nodes = len(nodes_desc)
    children_idx = -np.ones((num_nodes, k), np.int32)
    for nid, ch in enumerate(children):
        children_idx[nid, :len(ch)] = ch
    word_id = -np.ones(num_nodes, np.int32)
    leaf_ids = [nid for nid in range(num_nodes) if not children[nid]
                and nid != 0]
    for w, nid in enumerate(leaf_ids):
        word_id[nid] = w
    vocab = _tensors(np.stack(nodes_desc), children_idx, word_id,
                     np.ones(max(len(leaf_ids), 1), np.float32),
                     np.array(leaf_ids, np.int32), dev)
    word, _ = quantize_tree(
        vocab, torch.from_numpy(desc.view(np.int32).copy()).to(dev),
        torch.ones(desc.shape[0], dtype=torch.bool, device=dev), levels)
    counts = np.bincount(word.cpu().numpy(), minlength=len(leaf_ids))
    idf = np.log(desc.shape[0] / np.maximum(counts, 1.0)).astype(np.float32)
    return vocab._replace(word_weight=torch.from_numpy(
        np.maximum(idf, 1e-3)).to(dev))


# ---------------------------------------------------------------------------
# DBoW2 interchange formats
# ---------------------------------------------------------------------------

def _assemble(k: int, parents: np.ndarray, is_leaf: np.ndarray,
              descs: np.ndarray, weights: np.ndarray,
              device) -> TreeVocabulary:
    """The flattened tensors from per-node records (node 0 = root)."""
    num_nodes = parents.shape[0] + 1
    node_desc = np.zeros((num_nodes, 8), np.uint32)
    node_desc[1:] = descs
    children_idx = -np.ones((num_nodes, k), np.int32)
    fill = np.zeros(num_nodes, np.int32)
    for nid in range(1, num_nodes):
        p = parents[nid - 1]
        if fill[p] < k:
            children_idx[p, fill[p]] = nid
            fill[p] += 1
    word_id = -np.ones(num_nodes, np.int32)
    leaf_nodes = np.flatnonzero(
        np.concatenate([[False], is_leaf.astype(bool)]))
    word_id[leaf_nodes] = np.arange(leaf_nodes.size)
    word_weight = np.zeros(max(leaf_nodes.size, 1), np.float32)
    word_weight[:leaf_nodes.size] = weights[leaf_nodes - 1]
    return _tensors(node_desc, children_idx, word_id, word_weight,
                    leaf_nodes.astype(np.int32), device)


def load_tree_text(path: str, device=None) -> Tuple[TreeVocabulary, int]:
    """DBoW2 text format (TemplatedVocabulary::loadFromTextFile): header
    ``k L scoring weighting``, then ``parent is_leaf b0..b31 w`` per node.
    Returns (vocab, levels)."""
    with open(path) as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        rows = np.loadtxt(f, dtype=np.float64, ndmin=2)
    parents = rows[:, 0].astype(np.int32)
    is_leaf = rows[:, 1].astype(np.uint8)
    descs = np.ascontiguousarray(
        rows[:, 2:34].astype(np.uint8)).view(np.uint32)
    weights = rows[:, 34].astype(np.float32)
    return (_assemble(k, parents, is_leaf, descs, weights,
                      resolve_device(device)), levels)


def _host_tree(vocab: TreeVocabulary):
    ch = vocab.children_idx.cpu().numpy()
    nd = vocab.node_desc.cpu().numpy().view(np.uint32)
    wid = vocab.word_id.cpu().numpy()
    ww = vocab.word_weight.cpu().numpy()
    parent = np.zeros(nd.shape[0], np.int32)
    for nid in range(nd.shape[0]):
        for c in ch[nid]:
            if c >= 0:
                parent[c] = nid
    return nd, wid, ww, parent


def save_tree_text(path: str, vocab: TreeVocabulary, levels: int,
                   scoring: int = 0, weighting: int = 0) -> None:
    """Write DBoW2's text format (saveToTextFile)."""
    nd, wid, ww, parent = _host_tree(vocab)
    with open(path, "w") as f:
        f.write(f"{vocab.branching} {levels}  {scoring} {weighting}\n")
        for nid in range(1, nd.shape[0]):
            leaf = int(wid[nid] >= 0)
            w = float(ww[wid[nid]]) if leaf else 0.0
            f.write(f"{parent[nid]} {leaf} "
                    + " ".join(str(int(b)) for b in nd[nid].view(np.uint8))
                    + f" {w}\n")


def load_tree_binary(path: str, device=None) -> Tuple[TreeVocabulary, int]:
    """The fork's packed binary format (loadFromBinaryFile): u32 nb_nodes
    (root included), u32 size_node, i32 k, L, scoring, weighting; per node
    i32 parent, 32 descriptor bytes, f32 weight, u8 is_leaf."""
    with open(path, "rb") as f:
        head = np.fromfile(f, np.uint32, 2)
        nb_nodes, size_node = int(head[0]) - 1, int(head[1])
        k, levels, _scoring, _weighting = np.fromfile(f, np.int32, 4)
        raw = np.fromfile(f, np.uint8, nb_nodes * size_node)
    if size_node != 41:
        raise ValueError(f"{path}: unexpected node size {size_node}")
    rec = raw.reshape(nb_nodes, size_node)
    parents = rec[:, 0:4].copy().view(np.int32)[:, 0]
    descs = np.ascontiguousarray(rec[:, 4:36]).view(np.uint32)
    weights = rec[:, 36:40].copy().view(np.float32)[:, 0]
    is_leaf = rec[:, 40]
    return (_assemble(int(k), parents, is_leaf, descs, weights,
                      resolve_device(device)), int(levels))


def save_tree_binary(path: str, vocab: TreeVocabulary, levels: int,
                     scoring: int = 0, weighting: int = 0) -> None:
    """Write the fork's packed binary format (saveToBinaryFile)."""
    nd, wid, ww, parent = _host_tree(vocab)
    num_nodes = nd.shape[0]
    rec = np.zeros((num_nodes - 1, 41), np.uint8)
    for i, nid in enumerate(range(1, num_nodes)):
        rec[i, 0:4] = np.frombuffer(np.int32(parent[nid]).tobytes(),
                                    np.uint8)
        rec[i, 4:36] = nd[nid].view(np.uint8)
        leaf = wid[nid] >= 0
        w = np.float32(ww[wid[nid]] if leaf else 0.0)
        rec[i, 36:40] = np.frombuffer(w.tobytes(), np.uint8)
        rec[i, 40] = np.uint8(leaf)
    with open(path, "wb") as f:
        np.array([num_nodes, 41], np.uint32).tofile(f)
        np.array([vocab.branching, levels, scoring, weighting],
                 np.int32).tofile(f)
        rec.tofile(f)
