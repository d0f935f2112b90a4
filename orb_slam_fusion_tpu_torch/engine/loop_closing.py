"""Loop closing: detection, Sim3 verification, correction, global BA.

Counterpart of ``orb_slam_fusion_tpu/engine/loop_closing.py`` (the
reference's LoopClosing thread for one map): BoW candidate retrieval with
the covisibility exclusion and temporal consistency, a descriptor gate
over the candidate's covisible window, Sim3 RANSAC and LM, the
Sim3-guided projection validation, then CorrectLoop: an essential-graph
pose graph (4-DoF once the IMU is initialized), point and normal
re-mapping, duplicate fusion and a chunked background global BA that the
tracker ticks once per frame. Host bookkeeping (consistency groups, loop
edges, the ``stats`` funnel counters) is numpy and Python, as in the
reference; the device work is plain PyTorch (the reference's is XLA, not
a Pallas kernel). Detection is pipelined one keyframe deep: its results
stay on the device until the next keyframe reads them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import cameras, lie
from ..frontend import extractor, matcher
from ..map import map_state as ms
from ..place import KeyFrameDatabase, make_vocabulary
from ..place.database import _query, compute_bow_vector
from ..solver import ba as ba_mod
from ..solver.pose_graph import PoseGraphProblem, optimize_pose_graph
from ..solver.sim3 import optimize_sim3, sim3_ransac
from ..utils import libm, prng
from ..utils.scatter import masked_set_last


def _detect_candidates(m: ms.MapState, bow, present, vocab, kf_id: int,
                       guard_lo: int, top_k: int = 3, levels: int = 0):
    """Loop candidates of keyframe ``kf_id``: the covisibility exclusion
    (weight >= 15, relaxed to the 30 strongest links when fewer than 8
    rows would stay eligible), the temporal guard, BoW scoring and top-k.
    Returns device tensors (ids, scores, covisibility groups (top_k, K),
    number of eligible rows)."""
    K = m.max_kf
    dev = bow.device
    kf_c = min(max(kf_id, 0), K - 1)
    W = ms.covisibility_matrix(m)
    kfa = torch.arange(K, device=dev)
    temporal = (kfa >= guard_lo) & (kfa <= kf_id)
    cov = W[kf_c]
    excl_cov = cov >= 15
    n_elig0 = torch.sum((present & ~(excl_cov | temporal)).to(torch.int32))
    cap = min(30, K)
    ranked = torch.sort(torch.where(excl_cov & present, cov,
                                    torch.full_like(cov, -1)),
                        descending=True)[0]
    kth = ranked[cap - 1]
    excl_relaxed = excl_cov & (cov >= torch.clamp(kth, min=15))
    excl_cov = torch.where(n_elig0 >= 8, excl_cov, excl_relaxed)
    exclude = excl_cov | temporal
    q = compute_bow_vector(vocab, m.kf_desc[kf_c], m.kf_feat_valid[kf_c],
                           levels)
    ids, scores = _query(bow, present, q, exclude, top_k)
    ids_c = torch.clamp(ids, 0, K - 1).long()
    groups = (W[ids_c] > 0) | (kfa[None, :] == ids_c[:, None])
    groups = groups & (ids >= 0)[:, None]
    n_elig = torch.sum((present & ~exclude).to(torch.int32))
    return ids, scores, groups, n_elig


def _make_vocabulary(cfg, vocab_words: int, device):
    """A DBoW2 tree loaded from ``cfg.vocab_path`` (``.txt``: text format,
    else the packed binary), or the seeded flat codebook."""
    path = getattr(cfg, "vocab_path", "") or ""
    if path:
        from ..place.tree_vocabulary import load_tree_binary, load_tree_text
        if path.endswith(".txt"):
            return load_tree_text(path, device)
        return load_tree_binary(path, device)
    return make_vocabulary(vocab_words, device=device), 0


def _one_slot_per_point(obs: torch.Tensor, max_mp: int) -> torch.Tensor:
    """(N,) bool: slot i is the one slot kept for its point row, the
    last one holding it (the reference's scatter-max of positions)."""
    rows = torch.clamp(obs, 0, max_mp - 1).long()
    n = obs.shape[0]
    pos = torch.arange(1, n + 1, dtype=torch.int32, device=obs.device)
    # the largest position wins, as the reference's scatter-max
    slot = torch.where(obs >= 0, rows, torch.full_like(rows, max_mp))
    first = torch.zeros(max_mp + 1, dtype=torch.int32,
                        device=obs.device).scatter_reduce(
        0, slot, pos, reduce="amax")
    return first[rows] == pos


def _count_hits(idx: torch.Tensor, ok: torch.Tensor, F: int) -> int:
    """Number of distinct features matched."""
    hit = torch.zeros(F + 1, dtype=torch.bool, device=idx.device)
    hit[torch.where(ok, torch.clamp(idx, 0, F - 1),
                    torch.full_like(idx, F)).long()] = True
    return int(torch.sum(hit[:F].to(torch.int32)))


def _sim_at(S: lie.Sim3, k) -> lie.Sim3:
    return lie.Sim3(S.s[k], S.R[k], S.t[k])


def _project_map_points(mp_pos, mp_valid, pose: lie.SE3, cam_params,
                        cam_model: str, img_h: int, img_w: int):
    """Project points into a camera; visibility includes positive depth
    and the image bounds (reference Frame::isInFrustum)."""
    pc = lie.se3_apply(pose, mp_pos)
    uv = cameras.project(cam_model, cam_params, pc)
    vis = (mp_valid & (pc[..., 2] > 0.05)
           & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
           & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
    return uv, vis, pc[..., 2]


class ChunkedGBA:
    """Abortable, tracker-interleaved global BA (the reference's
    background GlobalBundleAdjustemnt thread): the LM carry stays on the
    device and the tracker advances it one chunk per tracked frame. The
    snapshot covers every keyframe row (the first held fixed); past 64
    keyframe slots the reduced system is solved matrix-free (PCG)."""

    def __init__(self, tracker, cfg, iters_first: int = 3,
                 iters_second: int = 7, chunk: int = 2):
        m = tracker.map
        dev = m.kf_valid.device
        self.cfg = cfg
        self.cam_model = cfg.cam_model
        self.snap_n_kf = int(m.n_kf)
        self.snap_n_mp = int(m.n_mp)
        n_kf = self.snap_n_kf
        window = torch.arange(m.max_kf, dtype=torch.int32, device=dev)
        window = torch.where(window < n_kf, window,
                             torch.full_like(window, -1))
        kf_idx, mp_idx, uv, octv, valid = ms.observation_triples(m, window)
        inv_s2 = extractor.inv_scale_sigma2(cfg.orb, device=dev)[
            torch.clamp(octv, 0, cfg.orb.num_levels - 1).long()]
        fixed = np.ones(m.max_kf, bool)
        fixed[1:n_kf] = False
        prob = ba_mod.make_problem(
            m.kf_pose, m.mp_pos, kf_idx, mp_idx, uv, inv_s2, valid,
            torch.from_numpy(fixed).to(dev), tracker.cam_params,
            fixed_point=~m.mp_valid, max_obs=16)
        stride = m.n_feat if m.max_kf > 64 else 0
        self.lm = ba_mod.ChunkedLM(prob, self.cam_model, iters_first,
                                   iters_second, chunk, pose_stride=stride)

    @property
    def prob(self):
        return self.lm.prob

    @property
    def poses(self):
        return self.lm.poses

    @property
    def points(self):
        return self.lm.points

    @property
    def done(self) -> bool:
        return self.lm.done

    def step(self) -> bool:
        """Advance by one device chunk (no host sync); True when done."""
        return self.lm.step()


class LoopCloser:
    def __init__(self, cfg, max_kf: int, vocab_words: int = 4096,
                 fix_scale: bool = False, device=None):
        from .. import resolve_device
        self.cfg = cfg
        self.device = resolve_device(device)
        vocab, levels = _make_vocabulary(cfg, vocab_words, self.device)
        self.db = KeyFrameDatabase(vocab, max_kf, levels)
        self.fix_scale = fix_scale
        self.last_loop_kf = -10 ** 9
        self.min_gap = 10           # keyframes between loop closures
        self.min_kf = 12            # the map needs >= 12 keyframes
        self.num_closed = 0
        self.max_kf_for_gba = 200   # GBA size gate for inertial maps
        # temporal consistency (reference ConsistentGroup): candidate
        # covisibility groups must recur over consecutive keyframes
        self._cons_groups: list = []   # [(frozenset(kf rows), count)]
        self.consistency_th = getattr(cfg, "loop_consistency_th", 3)
        # projection-validation thresholds scaled to the feature budget
        nf = cfg.orb.n_features
        s = min(1.0, max(0.3, nf / 1000.0))
        self.proj_th = max(15, int(getattr(cfg, "loop_proj_matches", 50) * s))
        self.proj_ref_th = max(
            20, int(getattr(cfg, "loop_proj_matches_ref", 80) * s))
        # accepted loop edges, re-entering every later essential graph
        self.loop_edges: list = []   # [(i, j, lie.Sim3 rel i->j)]
        self.pending_gba: Optional[ChunkedGBA] = None
        self._pending_detect = None
        self.background_gba = bool(getattr(cfg, "background_gba", True))
        self.stats = {"queries": 0, "candidates": 0, "consistent": 0,
                      "desc_fail": 0, "ransac_fail": 0, "sim3_fail": 0,
                      "proj_fail": 0, "closed": 0}

    # -- database maintenance ----------------------------------------------

    def add_keyframe(self, kf_id: int, desc, valid) -> None:
        self.db.add(kf_id, desc, valid)

    def on_kf_remap(self, old_to_new, order) -> None:
        """Follow a keyframe-table compaction: abort the GBA snapshot and
        the deferred detection, permute the BoW rows, remap stored ids."""
        self.pending_gba = None
        self._pending_detect = None
        self.db.permute(order)
        if self.last_loop_kf >= 0:
            n = int(old_to_new[self.last_loop_kf]) \
                if self.last_loop_kf < len(old_to_new) else -1
            self.last_loop_kf = n if n >= 0 else -10 ** 9
        self._cons_groups = [
            (frozenset(int(old_to_new[k]) for k in grp
                       if k < len(old_to_new) and old_to_new[k] >= 0), cnt)
            for grp, cnt in self._cons_groups]
        self._cons_groups = [(g, c) for g, c in self._cons_groups if g]
        edges = []
        for i, j, rel in self.loop_edges:
            if (i < len(old_to_new) and j < len(old_to_new)
                    and old_to_new[i] >= 0 and old_to_new[j] >= 0):
                edges.append((int(old_to_new[i]), int(old_to_new[j]), rel))
        self.loop_edges = edges

    def on_kf_grow(self, new_max_kf: int) -> None:
        self.db.grow(new_max_kf)

    # -- detection and closure ---------------------------------------------

    def try_close(self, tracker) -> bool:
        """Resolve the detection dispatched at the previous keyframe (and
        close its loop if verified), then dispatch the current keyframe's.
        Returns True if a loop was closed."""
        fired = False
        pending = self._pending_detect
        self._pending_detect = None
        if pending is not None:
            fired = self._resolve_detection(tracker, *pending)
        m = tracker.map
        kf_id = tracker.last_kf_id
        if kf_id < 0 or int(m.n_kf) < self.min_kf:
            return fired
        if kf_id - self.last_loop_kf < self.min_gap:
            return fired
        ids, scores, groups, n_elig = _detect_candidates(
            m, self.db.bow, self.db.present, self.db.vocab, kf_id,
            max(0, kf_id - 6), levels=self.db.levels)
        self._pending_detect = (kf_id, ids, groups, scores, n_elig)
        return fired

    def _resolve_detection(self, tracker, kf_id: int, ids, groups,
                           scores=None, n_elig=None) -> bool:
        """Temporal consistency, staged verification and correction of a
        deferred detection for keyframe ``kf_id``."""
        if kf_id >= int(tracker.map.n_kf):
            return False
        ids = ids.cpu().numpy()
        groups = groups.cpu().numpy()
        self.stats["queries"] += 1
        if n_elig is not None:
            ne = int(n_elig)
            self.stats["elig_last"] = ne
            if ne == 0:
                self.stats["elig_zero"] = self.stats.get("elig_zero", 0) + 1
        if scores is not None:
            bs = float(scores[0])
            self.stats["best_score_max"] = max(
                self.stats.get("best_score_max", -1.0), bs)
        consistent = []
        new_groups = []
        for ci, cand in enumerate(ids):
            if cand < 0:
                continue
            self.stats["candidates"] += 1
            grp = frozenset(np.nonzero(groups[ci])[0].tolist())
            best = 0
            for prev_grp, cnt in self._cons_groups:
                if grp & prev_grp:
                    best = max(best, cnt)
            new_groups.append((grp, best + 1))
            if best + 1 >= self.consistency_th:
                consistent.append(int(cand))
        self._cons_groups = new_groups
        self.stats["consistent"] += len(consistent)
        for cand in consistent:
            if self._verify_and_correct(tracker, kf_id, cand):
                self.last_loop_kf = kf_id
                self.num_closed += 1
                self.stats["closed"] += 1
                self._cons_groups = []
                return True
        return False

    def _covisible_window(self, m, cand: int, n_window: int = 6):
        """The candidate and its best covisible keyframes, padded to
        ``n_window`` by repeating the candidate."""
        n_kf = int(m.n_kf)
        Wc = ms.covisibility_matrix(m)[cand, :n_kf].cpu().numpy()
        order = np.argsort(-Wc)
        covis = [int(k) for k in order[: n_window - 1] if Wc[k] > 0]
        ids = [cand] + covis
        while len(ids) < n_window:
            ids.append(cand)
        return np.asarray(ids[:n_window], np.int32)

    def _window_points(self, m, cand: int):
        """(rows, has): the candidate window's observed point rows, each
        point counted once."""
        win = torch.from_numpy(self._covisible_window(m, cand)).to(
            m.kf_valid.device).long()
        obs = m.kf_obs_mp[win].reshape(-1)
        rows = torch.clamp(obs, 0, m.max_mp - 1).long()
        has = (obs >= 0) & m.mp_valid[rows] & _one_slot_per_point(obs,
                                                                m.max_mp)
        return rows, has

    def _verify_and_correct(self, tracker, cur: int, cand: int) -> bool:
        m = tracker.map
        F = m.n_feat
        # stage 1: descriptor gate over the candidate window's points
        rows_w, has_w = self._window_points(m, cand)
        idx, ok = matcher.match_masked(
            m.mp_desc[rows_w], m.kf_desc[cur],
            has_w[:, None] & m.kf_feat_valid[cur][None, :],
            max_dist=matcher.TH_LOW, ratio=0.75)
        n_matches = _count_hits(idx, ok, F)
        if n_matches < max(15, int(20 * min(1.0, F / 1000.0) + 0.5)):
            self.stats["desc_fail"] += 1
            return False

        # stage 2: Sim3 RANSAC on 3D-3D pairs
        idx_c = torch.clamp(idx, 0, F - 1).long()
        mp_cand = rows_w
        mp_cur_row = m.kf_obs_mp[cur][idx_c]
        mp_cur = torch.clamp(mp_cur_row, 0, m.max_mp - 1).long()
        pair_ok = ok & (mp_cur_row >= 0) & m.mp_valid[mp_cur]
        pose_cand = lie.SE3(m.kf_pose.R[cand], m.kf_pose.t[cand])
        pose_cur = lie.SE3(m.kf_pose.R[cur], m.kf_pose.t[cur])
        x1 = lie.se3_apply(pose_cand, m.mp_pos[mp_cand])
        x2 = lie.se3_apply(pose_cur, m.mp_pos[mp_cur])
        uv1 = cameras.project(self.cfg.cam_model, tracker.cam_params, x1)
        uv2 = m.kf_uv[cur][idx_c]
        # an initialized IMU makes scale observable
        fix_scale = self.fix_scale or bool(
            getattr(tracker, "imu_initialized", False))
        res = sim3_ransac(
            x1, x2, pair_ok, uv1, uv2, tracker.cam_params,
            prng.PRNGKey(cur * 7919 + cand), fix_scale=fix_scale,
            min_inliers=15, cam_model=self.cfg.cam_model)
        if not bool(res.ok):
            self.stats["ransac_fail"] += 1
            self.stats["ransac_pairs_last"] = int(
                torch.sum(pair_ok.to(torch.int32)))
            self.stats["ransac_best_last"] = int(res.n_inliers)
            self.stats["same_row_last"] = int(
                torch.sum((pair_ok & (mp_cand == mp_cur)).to(torch.int32)))
            return False
        n_pairs = x1.shape[0]
        ones = torch.ones(n_pairs, dtype=torch.float32, device=x1.device)
        S_ref, _, n_in = optimize_sim3(
            res.sim, x1, x2, pair_ok, uv1, uv2, ones, ones,
            tracker.cam_params, fix_scale=fix_scale,
            cam_model=self.cfg.cam_model)
        if int(n_in) < 20:
            self.stats["sim3_fail"] += 1
            return False
        ok_proj, S_final = self._sim3_guided_validation(
            tracker, cur, cand, S_ref, fix_scale)
        if not ok_proj:
            self.stats["proj_fail"] += 1
            return False
        self._correct_loop(tracker, cur, cand, S_final)
        return True

    def _project_candidate_points(self, tracker, cur: int, rows, has,
                                  x_cand, S: lie.Sim3, radius: float):
        """Sim3-guided projection search of candidate-side points in the
        current keyframe. Returns (midx, mok) per candidate row."""
        m = tracker.map
        h, w = self.cfg.image_size
        x_pred = lie.sim3_apply(S, x_cand)
        uv_pred = cameras.project(self.cfg.cam_model, tracker.cam_params,
                                  x_pred)
        vis = (has & (x_pred[..., 2] > 0.05)
               & (uv_pred[..., 0] >= 0) & (uv_pred[..., 0] < w)
               & (uv_pred[..., 1] >= 0) & (uv_pred[..., 1] < h))
        d = ms.vec_norm(x_pred)
        pred_oct = ms.predict_scale(d, m.mp_max_dist[rows] * S.s,
                                    self.cfg.orb.num_levels)
        return matcher.search_by_projection(
            uv_pred, m.mp_desc[rows], vis, pred_oct,
            m.kf_uv[cur], m.kf_desc[cur], m.kf_feat_valid[cur],
            m.kf_octave[cur],
            radius=radius * libm.octave_pow(pred_oct),
            max_dist=matcher.TH_LOW, octave_window=2)

    def _sim3_guided_validation(self, tracker, cur: int, cand: int,
                                S: lie.Sim3, fix_scale: bool):
        """Project the candidate window's points through S (>= proj_th
        matched features), refine S on the candidate row's guided
        matches, recount at the refined S (>= proj_ref_th). Returns
        (ok, refined S)."""
        m = tracker.map
        F = m.n_feat
        pose_cand = lie.SE3(m.kf_pose.R[cand], m.kf_pose.t[cand])
        pose_cur = lie.SE3(m.kf_pose.R[cur], m.kf_pose.t[cur])
        rows, has = self._window_points(m, cand)
        x_cand = lie.se3_apply(pose_cand, m.mp_pos[rows])
        midx, mok = self._project_candidate_points(
            tracker, cur, rows, has, x_cand, S, radius=8.0)
        if _count_hits(midx, mok, F) < self.proj_th:
            return False, S

        obs_c = m.kf_obs_mp[cand]
        rows_c = torch.clamp(obs_c, 0, m.max_mp - 1).long()
        has_c = (obs_c >= 0) & m.mp_valid[rows_c]
        x1 = lie.se3_apply(pose_cand, m.mp_pos[rows_c])
        midx_c, mok_c = self._project_candidate_points(
            tracker, cur, rows_c, has_c, x1, S, radius=8.0)
        f_idx = torch.clamp(midx_c, 0, F - 1).long()
        cur_obs = m.kf_obs_mp[cur][f_idx]
        cur_rows = torch.clamp(cur_obs, 0, m.max_mp - 1).long()
        both = mok_c & has_c & (cur_obs >= 0) & m.mp_valid[cur_rows]
        x2 = lie.se3_apply(pose_cur, m.mp_pos[cur_rows])
        ones = torch.ones(F, dtype=torch.float32, device=x1.device)
        S2, _, _ = optimize_sim3(
            S, x1, x2, both, m.kf_uv[cand], m.kf_uv[cur][f_idx], ones, ones,
            tracker.cam_params, fix_scale=fix_scale,
            cam_model=self.cfg.cam_model)
        midx2, mok2 = self._project_candidate_points(
            tracker, cur, rows, has, x_cand, S2, radius=5.0)
        if _count_hits(midx2, mok2, F) < self.proj_ref_th:
            return False, S
        return True, S2

    # -- correction ---------------------------------------------------------

    def _correct_loop(self, tracker, cur: int, cand: int,
                      S_cand_to_cur: lie.Sim3) -> None:
        """Essential-graph correction (reference CorrectLoop): spanning
        tree over the live keyframes, strong covisibility edges (>= 30),
        earlier loop edges and the new one; then points and normals follow
        their reference keyframe, duplicates fuse, and a global BA
        starts."""
        m = tracker.map
        dev = m.kf_valid.device
        K = int(m.n_kf)
        poses = lie.Sim3(torch.ones(K, dtype=torch.float32, device=dev),
                         m.kf_pose.R[:K], m.kf_pose.t[:K])

        def rel(j, i):
            return lie.sim3_compose(_sim_at(poses, j),
                                    lie.sim3_inverse(_sim_at(poses, i)))

        live = np.nonzero(m.kf_valid[:K].cpu().numpy())[0]
        Wc = ms.covisibility_matrix(m)[:K, :K].cpu().numpy()
        live_mask = np.zeros(K, bool)
        live_mask[live] = True
        edge_i, edge_j, rels, weights = [], [], [], []
        for a_idx in range(1, len(live)):
            b = int(live[a_idx])
            w_row = np.where(live_mask[:b], Wc[b, :b], -1)
            parent = int(np.argmax(w_row)) if w_row.max() > 0 \
                else int(live[a_idx - 1])
            edge_i.append(parent)
            edge_j.append(b)
            rels.append(rel(b, parent))
            weights.append(1.0)
        strong = np.argwhere(np.triu(Wc, 2) >= 30)
        for i, j in strong[:200]:
            edge_i.append(int(i))
            edge_j.append(int(j))
            rels.append(rel(int(j), int(i)))
            weights.append(1.0)
        for (pi, pj, prel) in self.loop_edges:
            if pi < K and pj < K:
                edge_i.append(pi)
                edge_j.append(pj)
                rels.append(prel)
                weights.append(float(K))
        edge_i.append(cand)
        edge_j.append(cur)
        rels.append(S_cand_to_cur)
        weights.append(float(len(edge_i)))
        self.loop_edges.append((cand, cur, S_cand_to_cur))

        rel_b = lie.Sim3(*(torch.stack([getattr(r, f) for r in rels])
                           for f in ("s", "R", "t")))
        fixed = np.zeros(K, bool)
        fixed[cand] = True
        fixed |= ~m.kf_valid[:K].cpu().numpy()
        E = len(edge_i)
        prob = PoseGraphProblem(
            poses=poses,
            edge_i=torch.tensor(edge_i, dtype=torch.int32, device=dev),
            edge_j=torch.tensor(edge_j, dtype=torch.int32, device=dev),
            edge_rel=rel_b,
            edge_weight=torch.tensor(weights, dtype=torch.float32,
                                     device=dev),
            edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
            fixed=torch.from_numpy(fixed).to(dev))
        four_dof = bool(getattr(tracker, "imu_initialized", False))
        new_poses, _ = optimize_pose_graph(prob, iters=25,
                                           four_dof=four_dof)

        corr_R = new_poses.R
        corr_t = new_poses.t / new_poses.s[:, None]
        ref = torch.clamp(m.mp_ref_kf, 0, K - 1).long()
        old_ref = _sim_at(poses, ref)
        new_ref = _sim_at(new_poses, ref)
        X_new = lie.sim3_apply(lie.sim3_inverse(new_ref),
                               lie.sim3_apply(old_ref, m.mp_pos))
        v = m.mp_valid[:, None]
        mp_pos = torch.where(v, X_new, m.mp_pos)
        R_corr = torch.einsum("mji,mjk->mik", new_ref.R, old_ref.R)
        nrm = torch.einsum("mij,mj->mi", R_corr, m.mp_normal)
        mp_normal = torch.where(v, nrm, m.mp_normal)
        kf_R = m.kf_pose.R.clone()
        kf_t = m.kf_pose.t.clone()
        kf_R[:K] = corr_R
        kf_t[:K] = corr_t
        tracker.map = m._replace(kf_pose=lie.SE3(kf_R, kf_t), mp_pos=mp_pos,
                                 mp_normal=mp_normal)
        # the in-flight local BA solved the pre-correction geometry
        tracker._pending_lba = None
        tracker.cur_pose = lie.SE3(kf_R[cur], kf_t[cur])
        tracker.velocity = lie.se3_identity(device=dev)
        tracker._reset_prior()

        self._fuse_duplicates(tracker, cur, cand)

        # global BA: every visual map, an inertial one up to 200 keyframes
        if (not bool(getattr(tracker, "imu_initialized", False))
                or K <= self.max_kf_for_gba):
            if getattr(tracker, "mesh", None) is not None:
                self._global_ba_dist(tracker)
            else:
                self.pending_gba = ChunkedGBA(tracker, self.cfg)
                if not self.background_gba:
                    self.gba_drain(tracker)

    # -- chunked background GBA --------------------------------------------

    def gba_tick(self, tracker) -> None:
        """Advance the in-flight GBA by one chunk (once per tracked
        frame); adopt the result into the live map when done."""
        g = self.pending_gba
        if g is None:
            return
        if g.step():
            self._adopt_gba(tracker)

    def gba_drain(self, tracker) -> None:
        """Run the in-flight GBA to completion."""
        while self.pending_gba is not None:
            self.gba_tick(tracker)

    def _global_ba_dist(self, tracker) -> None:
        """Loop-closure GBA through the landmark-sharded distributed Schur
        reduction (parallel/dist_ba.py) when the tracker runs on a mesh,
        synchronously; the result is merged through the same correction
        propagation as the chunked path."""
        from ..parallel.dist_ba import distributed_bundle_adjustment
        g = ChunkedGBA(tracker, self.cfg)
        dev = tracker.map.kf_valid.device
        poses, points, _ = distributed_bundle_adjustment(
            g.prob, tracker.mesh, cam_model=self.cfg.cam_model, iters=3,
            iters_second=7)
        g.lm.poses = lie.SE3(poses.R.to(dev), poses.t.to(dev))
        g.lm.points = points.to(dev)
        g.lm.phase = 2
        self.pending_gba = g
        self._adopt_gba(tracker)

    def _adopt_gba(self, tracker) -> None:
        """Merge a finished GBA into the live map: snapshot rows take the
        optimized values; keyframes added during the solve follow their
        relative pose to the newest snapshot keyframe, newer points their
        reference keyframe."""
        g = self.pending_gba
        self.pending_gba = None
        m = tracker.map
        dev = m.kf_valid.device
        K0, M0 = g.snap_n_kf, g.snap_n_mp
        Kc, Mc = m.max_kf, m.max_mp
        gR, gt, gpts = g.poses.R, g.poses.t, g.points
        if gR.shape[0] < Kc:     # the tables grew since the snapshot
            pad = Kc - gR.shape[0]
            gR = torch.cat([gR, torch.eye(3, dtype=gR.dtype, device=dev)
                            .expand(pad, 3, 3)])
            gt = torch.cat([gt, torch.zeros((pad, 3), dtype=gt.dtype,
                                            device=dev)])
        if gpts.shape[0] < Mc:
            gpts = torch.cat([gpts, torch.zeros(
                (Mc - gpts.shape[0], 3), dtype=gpts.dtype, device=dev)])
        snap_kf = torch.arange(Kc, device=dev) < K0
        snap_mp = torch.arange(Mc, device=dev) < M0
        a = K0 - 1
        T_a_now = lie.SE3(m.kf_pose.R[a], m.kf_pose.t[a])
        T_a_corr = lie.SE3(gR[a], gt[a])
        Dr = lie.se3_compose(lie.se3_inverse(T_a_now), T_a_corr)
        prop = lie.se3_compose(m.kf_pose, Dr)
        kf_R = torch.where(snap_kf[:, None, None], gR, prop.R)
        kf_t = torch.where(snap_kf[:, None], gt, prop.t)
        ref = torch.clamp(m.mp_ref_kf, 0, Kc - 1).long()
        T_r_now = lie.SE3(m.kf_pose.R[ref], m.kf_pose.t[ref])
        T_r_corr = lie.SE3(kf_R[ref], kf_t[ref])
        X_prop = lie.se3_apply(lie.se3_inverse(T_r_corr),
                               lie.se3_apply(T_r_now, m.mp_pos))
        mp_pos = torch.where(snap_mp[:, None], gpts, X_prop)
        mp_pos = torch.where(m.mp_valid[:, None], mp_pos, m.mp_pos)
        tracker.map = m._replace(kf_pose=lie.SE3(kf_R, kf_t), mp_pos=mp_pos)
        tracker._pending_lba = None
        if tracker.last_kf_id >= 0:
            k = tracker.last_kf_id
            tracker.cur_pose = lie.SE3(tracker.map.kf_pose.R[k],
                                       tracker.map.kf_pose.t[k])
        tracker._reset_prior()

    def _fuse_duplicates(self, tracker, cur: int, cand: int) -> None:
        """Current-keyframe features re-matched to the candidate's points
        adopt them; the replaced current-side points are invalidated."""
        m = tracker.map
        F = m.n_feat
        pose_cur = lie.SE3(m.kf_pose.R[cur], m.kf_pose.t[cur])
        cand_obs = m.kf_obs_mp[cand]
        cand_mp = torch.clamp(cand_obs, 0, m.max_mp - 1)
        cm = cand_mp.long()
        cand_has = (cand_obs >= 0) & m.kf_feat_valid[cand]
        h, w = self.cfg.image_size
        uv_pred, vis, _ = _project_map_points(
            m.mp_pos[cm], cand_has & m.mp_valid[cm], pose_cur,
            tracker.cam_params, self.cfg.cam_model, h, w)
        C_cur = -torch.einsum("ji,j->i", pose_cur.R, pose_cur.t)
        d_cur = ms.vec_norm(m.mp_pos[cm] - C_cur[None, :])
        pred_oct = ms.predict_scale(d_cur, m.mp_max_dist[cm],
                                    self.cfg.orb.num_levels)
        midx, mok = matcher.search_by_projection(
            uv_pred, m.mp_desc[cm], vis, pred_oct,
            m.kf_uv[cur], m.kf_desc[cur], m.kf_feat_valid[cur],
            m.kf_octave[cur],
            radius=8.0 * libm.octave_pow(pred_oct),
            max_dist=matcher.TH_LOW, octave_window=1)
        midx_c = torch.clamp(midx, 0, F - 1).long()
        cur_obs_row = m.kf_obs_mp[cur]
        dup = mok & (cur_obs_row[midx_c] >= 0) \
            & (cur_obs_row[midx_c] != cand_mp)
        # two candidate points matched to one feature: the last one wins,
        # as the reference's scatter on the CPU
        new_cur_obs = masked_set_last(cur_obs_row, midx_c, cand_mp, mok)
        kfo = m.kf_obs_mp.clone()
        kfo[cur] = new_cur_obs
        dup_rows = torch.clamp(cur_obs_row[midx_c], 0, m.max_mp - 1)
        mp_valid = masked_set_last(
            m.mp_valid, dup_rows,
            torch.zeros(F, dtype=torch.bool, device=m.mp_valid.device), dup)
        tracker.map = m._replace(kf_obs_mp=kfo, mp_valid=mp_valid)
