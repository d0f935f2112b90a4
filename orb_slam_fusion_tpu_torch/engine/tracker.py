"""Monocular tracking + local mapping session.

Counterpart of ``orb_slam_fusion_tpu/engine/tracker.py``'s ``MonoTracker``
without a loop closer: the host runs the state machine (INIT -> OK ->
LOST), the keyframe decision, capacity management, keyframe culling and
the background local-BA protocol; the device runs extraction, two-view
init, the fused tracking step (whose masked Hamming matches launch the
CUDA kernel on a CUDA device), the mapping step and local BA. Names,
structure and host bookkeeping (numpy, as in the reference) follow the
reference so each counterpart is easy to find.

Cameras: pinhole (with radial-tangential keypoint undistortion for a
non-zero ``distortion``) and Kannala-Brandt 8. The stereo, RGB-D and
fisheye-stereo sessions subclass this one (``engine/stereo_tracker.py``).

With ``loop_closing=True`` (the default) the session owns a loop closer
(``engine/loop_closing.py``: BoW database, loop detection and correction,
the background global BA it ticks once per frame), relocalizes a lost
frame against that database by PnP, archives its map into the atlas when
the grace window runs out, and merges the active map back into an
archived one that a keyframe recognizes (``_try_merge_maps``).

With ``mesh_devices > 0`` the session runs on a mesh (``parallel/``):
per-frame tracking through the map-sharded ``distributed_frame_update``,
local BA synchronously through the landmark-sharded
``distributed_bundle_adjustment`` (no background BA), and the loop
closer's global BA through the same. On a CUDA device the mesh takes
``min(mesh_devices, torch.cuda.device_count())`` cards, on the CPU
``mesh_devices`` shards of the CPU; ``tracker.mesh`` may be replaced by
any ``SlamMesh`` (``[cuda:0] * 8`` runs the 8-way split on one card).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import cameras, lie, resolve_device, two_view
from ..frontend import extractor, matcher
from ..map import map_state as ms
from ..solver import ba as ba_mod
from ..map.atlas import Atlas, merge_maps
from ..solver.local_ba import stereo_args
from ..utils import masked_set, masked_set_last, prng
from ..utils.timing import STAGES, stage
from .config import SlamConfig


class TrackState(enum.Enum):
    NO_IMAGES = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class FrameRecord(NamedTuple):
    timestamp: float
    pose: lie.SE3          # Tcw
    tracked: int
    state: str


def _pose_at(m: ms.MapState, k: int) -> lie.SE3:
    return lie.SE3(m.kf_pose.R[k], m.kf_pose.t[k])


def _host(T: lie.SE3):
    return T.R.detach().cpu().numpy(), T.t.detach().cpu().numpy()


# A rotation's distance from SO(3) (max |R^T R - I|, ~100 float32 ulps)
# past which the background BA's shift of the live pose re-orthonormalizes
# it. The shift, cur o inv(old) o new with inv a transpose, triples the
# distance its rotations share, and keyframes made from the live pose
# carry it on. How often that happens is decided by rounding: one ulp of
# translation at frame 1 takes the JAX package's own stereo session from
# 3.7 mm to 0.16 m of ATE (tests/torch_rotation_drift.py). The JAX
# package has no such step (ROADMAP C6); below the bound the port keeps
# its semantics.
ROTATION_DRIFT_TOL = 1e-5


def keep_on_so3(T: lie.SE3) -> lie.SE3:
    if float(lie.so3_orthonormality_error(T.R)) <= ROTATION_DRIFT_TOL:
        return T
    return lie.SE3(lie.so3_normalize(T.R), T.t)


class ChunkedLocalBA:
    """Background windowed local BA: the keyframe-rate bundle adjustment
    spread over the following tracked frames as fixed-size device chunks
    (reference: LocalMapping's BA running beside tracking, aborted by
    mbAbortBA, localmapping.cc:106-146,226). The problem is a snapshot of
    the map at the keyframe; a structural map change drains it first."""

    def __init__(self, tracker, window, fixed, chunk: int = 0):
        cfg = tracker.cfg
        if chunk <= 0:
            # one tick completes the whole robust phase, whose end state
            # (post outlier re-mask) is the first one safe to scatter
            chunk = max(1, cfg.ba_iters_first)
        m = tracker.map
        dev = tracker.device
        self.window = np.asarray(window)
        self.win = torch.as_tensor(self.window, dtype=torch.int32,
                                   device=dev)
        self.wclip = torch.clamp(self.win, 0, m.max_kf - 1).long()
        W = self.win.shape[0]
        kf_idx, mp_idx, uv, octv, valid = ms.observation_triples(m,
                                                                 self.win)
        inv_s2 = tracker.inv_s2[torch.clamp(
            octv, 0, cfg.orb.num_levels - 1).long()]
        poses = lie.SE3(m.kf_pose.R[self.wclip], m.kf_pose.t[self.wclip])
        fixed_t = torch.as_tensor(np.asarray(fixed), device=dev)
        # stereo sessions add their right-image u rows (reference
        # tracker.py:116-124)
        prob = ba_mod.make_window_problem(
            poses, m.mp_pos, kf_idx, mp_idx, uv, inv_s2, valid,
            fixed_t | (self.win < 0), tracker.cam_params, window_size=W,
            fixed_point=~m.mp_valid,
            **stereo_args(getattr(tracker, "kf_uright", None),
                          getattr(tracker, "bf", 0.0), self.wclip, valid))
        self.valid = valid
        self.lm = ba_mod.ChunkedLM(prob, cfg.cam_model, cfg.ba_iters_first,
                                   cfg.ba_iters_second, chunk,
                                   window_layout=True)
        live = self.window[self.window >= 0]
        self.newest_kf = int(live[-1]) if len(live) else -1
        self.old_newest = (_pose_at(m, self.newest_kf)
                           if self.newest_kf >= 0 else None)
        # True once the phase-0 result has been scattered into the map
        self.scattered = False


class MonoTracker:
    """Host-side monocular SLAM session: tracking, local mapping, loop
    closing, relocalization and the multi-map atlas."""

    # covisible local-BA window for monocular sessions (reference visual
    # LocalBundleAdjustment, optimizer.cc:1053); metric subclasses
    # override to the contiguous temporal window
    ba_covisible_window = True

    def __init__(self, config: SlamConfig = SlamConfig(), device=None):
        if config.cam_model not in (cameras.PINHOLE,
                                    cameras.KANNALA_BRANDT8):
            raise ValueError(f"unknown camera model {config.cam_model!r}")
        self.cfg = config
        self.device = resolve_device(device)
        dev = self.device
        self.cam_params = torch.tensor(config.cam_params, dtype=torch.float32,
                                       device=dev)
        self.inv_s2 = extractor.inv_scale_sigma2(config.orb, device=dev)
        self.map = ms.make_empty_map(
            config.max_keyframes, config.max_map_points,
            config.orb.n_features, device=dev)
        self.state = TrackState.NO_IMAGES
        self.cur_pose = lie.se3_identity(device=dev)
        self.velocity = lie.se3_identity(device=dev)
        self.last_pose: Optional[lie.SE3] = None
        self.ref_feats: Optional[extractor.Features] = None
        self.ref_timestamp = 0.0
        self.last_kf_id = -1
        self.last_kf_tracked = 0
        self._last_kf_tracked_dev = None   # lazily-read device scalar
        self.frames_since_kf = 0
        self.frame_id = 0
        self.trajectory: list[FrameRecord] = []
        # keyframe-relative trajectory (reference tracking.cc:1661-1678):
        # (timestamp, kf_id, T_rel) or (timestamp, -1, Tcw)
        self._traj_rel: list = []
        self._cur_obs = None
        self._pending_lba: Optional[ChunkedLocalBA] = None
        self.loop_closer = self._new_loop_closer()
        self.lost_since = -10 ** 9
        self.reloc_grace_frames = 40  # ~2 s at 20 fps
        # multi-map atlas (reference Atlas + MergeLocal); needs the BoW
        # database of the loop closer
        self.atlas = Atlas()
        self.enable_atlas = config.loop_closing
        self._merge_cooldown = 0
        # distributed execution: map-sharded tracking and landmark-sharded
        # BA over a mesh (SlamConfig.mesh_devices)
        self.mesh = self._new_mesh(config.mesh_devices)

    def _new_mesh(self, n: int):
        """The reference's ``min(N, available devices)``: on a CUDA device
        that many cards, on the CPU ``n`` shards of it."""
        if n <= 0:
            return None
        from ..parallel.mesh import make_slam_mesh
        if self.device.type == "cuda":
            return make_slam_mesh(min(n, torch.cuda.device_count()))
        return make_slam_mesh(devices=[self.device] * n)

    def _new_loop_closer(self):
        if not self.cfg.loop_closing:
            return None
        from .loop_closing import LoopCloser
        return LoopCloser(self.cfg, self.cfg.max_keyframes,
                          self.cfg.vocab_words, device=self.device)

    def reset_map(self):
        """Archive the current map into the atlas and start a fresh one
        (reference Tracking::CreateMapInAtlas)."""
        # finish in-flight background solves so the archive is refined
        self._lba_drain()
        if self.loop_closer is not None:
            self.loop_closer.gba_drain(self)
        self._freeze_trajectory()
        cfg = self.cfg
        if (self.enable_atlas and self.loop_closer is not None
                and int(self.map.n_kf) >= 5):
            self.atlas.archive(self.map, self.loop_closer.db.bow,
                               self.loop_closer.db.present,
                               inertial=self._inertial_archive_snapshot())
        self.map = ms.make_empty_map(
            cfg.max_keyframes, cfg.max_map_points, cfg.orb.n_features,
            device=self.device)
        self.state = TrackState.NOT_INITIALIZED
        self.ref_feats = None
        self.velocity = lie.se3_identity(device=self.device)
        self.last_kf_id = -1
        self.last_kf_tracked = 0
        self._last_kf_tracked_dev = None
        self.frames_since_kf = 0
        if self.loop_closer is not None:
            self.loop_closer = self._new_loop_closer()

    # -- public API --------------------------------------------------------

    def process_image(self, img, timestamp: float) -> FrameRecord:
        """``img``: (H, W) image, a tensor or an array (copied to the
        tracker's device)."""
        with stage("orb_extract"):
            feats = extractor.extract_features(self._image(img),
                                               self.cfg.orb)
        return self.process_features(self._undistort(feats), timestamp)

    def _image(self, img) -> torch.Tensor:
        """An image (tensor or array) as float32 on the tracker's device."""
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.asarray(img, np.float32))
        return img.to(self.device, torch.float32)

    def _undistort(self, feats: extractor.Features) -> extractor.Features:
        """Undistort keypoint coordinates for unrectified pinhole inputs
        (reference Frame::UndistortKeyPoints): extraction ran on the raw
        image; only the coordinates geometry uses are remapped. No-op
        without a distortion (rectified stereo, KB8 fisheye)."""
        dist = self.cfg.distortion
        if not dist or not any(dist):
            return feats
        dev = feats.uv.device
        uv = cameras.undistort_points(
            torch.tensor(self.cfg.cam_params[:4], dtype=torch.float32,
                         device=dev),
            torch.tensor(dist, dtype=torch.float32, device=dev), feats.uv)
        return feats._replace(uv=uv)

    def process_features(self, feats: extractor.Features,
                         timestamp: float) -> FrameRecord:
        """Main per-frame entry (reference: Tracking::Track)."""
        if self.state in (TrackState.NO_IMAGES, TrackState.NOT_INITIALIZED):
            with stage("initialize"):
                rec = self._try_initialize(feats, timestamp)
        elif self.state == TrackState.OK:
            with stage("track_frame"):
                rec = self._track_frame(feats, timestamp)
        else:  # LOST: relocalize for a grace window, then a fresh map
            if (self.frame_id - self.lost_since <= self.reloc_grace_frames
                    and self._try_relocalize(feats)):
                anchor = self.lost_since
                rec = self._track_frame(feats, timestamp)
                if self.state == TrackState.LOST:
                    self.lost_since = anchor
            elif self.frame_id - self.lost_since <= self.reloc_grace_frames:
                rec = FrameRecord(timestamp, self.cur_pose, 0, "reloc-fail")
            else:
                self.reset_map()
                rec = self._bootstrap(feats, timestamp)
        self.frame_id += 1
        self._append_record(rec)
        return rec

    def _append_record(self, rec: FrameRecord) -> None:
        self.trajectory.append(rec)
        kf = self.last_kf_id
        if kf >= 0 and self.state == TrackState.OK:
            T_rel = lie.se3_compose(rec.pose,
                                    lie.se3_inverse(_pose_at(self.map, kf)))
            self._traj_rel.append((rec.timestamp, kf, T_rel))
        else:
            self._traj_rel.append((rec.timestamp, -1, rec.pose))

    def _freeze_trajectory(self) -> None:
        """Resolve keyframe-relative entries to absolute poses against the
        current map (before the map is replaced)."""
        self._traj_rel = [(ts, -1, self._resolve_pose(kf, T))
                          for ts, kf, T in self._traj_rel]

    def _resolve_pose(self, kf: int, T) -> lie.SE3:
        if kf < 0:
            return T
        return lie.se3_compose(T, _pose_at(self.map, kf))

    def resolved_poses(self):
        """(timestamp, Tcw) per frame, with keyframe corrections applied."""
        self._lba_drain()
        return [(ts, self._resolve_pose(kf, T))
                for ts, kf, T in self._traj_rel]

    # -- initialization ----------------------------------------------------

    def _bootstrap(self, feats, timestamp) -> FrameRecord:
        """(Re-)initialization after a map reset: two-view init."""
        return self._try_initialize(feats, timestamp)

    def _rays(self, uv):
        return cameras.unproject(self.cfg.cam_model, self.cam_params, uv)

    def _try_initialize(self, feats, timestamp) -> FrameRecord:
        cfg = self.cfg
        if self.ref_feats is None:
            self.ref_feats = feats
            self.ref_timestamp = timestamp
            self.state = TrackState.NOT_INITIALIZED
            return FrameRecord(timestamp, self.cur_pose, 0, "init-ref")

        idx, ok = matcher.match_mutual(
            self.ref_feats.desc, self.ref_feats.valid,
            feats.desc, feats.valid, max_dist=matcher.TH_LOW)
        n_matches = int(torch.sum(ok.to(torch.int32)))
        if n_matches < cfg.init_min_matches:
            self.ref_feats = feats
            self.ref_timestamp = timestamp
            return FrameRecord(timestamp, self.cur_pose, n_matches,
                               "init-no-match")

        idx_c = torch.clamp(idx, 0, feats.uv.shape[0] - 1).long()
        res = two_view.two_view_init(
            self._rays(self.ref_feats.uv), self._rays(feats.uv)[idx_c], ok,
            prng.PRNGKey(self.frame_id), min_inliers=cfg.init_min_inliers)
        if not bool(res.ok):
            return FrameRecord(timestamp, self.cur_pose, n_matches,
                               "init-fail")

        self._create_initial_map(feats, timestamp, idx, res)
        self.state = TrackState.OK
        return FrameRecord(timestamp, self.cur_pose,
                           int(res.n_inliers), "init-done")

    def _create_initial_map(self, feats, timestamp, idx, res):
        """Build the two-keyframe map (reference
        Tracking::CreateInitialMapMonocular, tracking.cc:1822)."""
        cfg = self.cfg
        dev = self.device
        inl = res.inliers.cpu().numpy()
        X1 = res.points1.cpu().numpy()
        # median-depth gauge normalization (tracking.cc: invMedianDepth)
        med = float(np.median(X1[inl, 2])) if inl.any() else 1.0
        X1 = X1 / med
        t21 = res.t21.cpu().numpy() / med

        pose0 = lie.se3_identity(device=dev)
        pose1 = lie.SE3(res.R21, torch.from_numpy(t21).to(dev))
        n_feat = cfg.orb.n_features
        pos = torch.from_numpy(X1).to(dev)
        dist = ms.vec_norm(pos)
        normals = pos / torch.clamp(dist[:, None], min=1e-9)
        min_d, max_d = ms.scale_invariance_band(
            dist, self.ref_feats.octave, cfg.orb.num_levels)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        self.map, mp_ids = ms.add_map_points(
            self.map, pos, self.ref_feats.desc, normals, zero, zero,
            res.inliers, min_dist=min_d, max_dist=max_d)

        # keyframe 0: feature f of ref observes mp_ids[f]
        self.map, _ = ms.add_keyframe(
            self.map, pose0, self.ref_timestamp, self.ref_feats.uv,
            self.ref_feats.desc, self.ref_feats.octave,
            self.ref_feats.valid, mp_ids)
        # keyframe 1: feature idx[f] observes mp_ids[f]
        obs1 = masked_set(
            torch.full((n_feat,), -1, dtype=torch.int32, device=dev),
            torch.clamp(idx, 0, n_feat - 1), mp_ids, (mp_ids >= 0)
            & (idx >= 0))
        self.map, kf1 = ms.add_keyframe(
            self.map, pose1, timestamp, feats.uv, feats.desc,
            feats.octave, feats.valid, obs1)

        self.cur_pose = pose1
        self.last_pose = pose0
        # the ref->current gap may span many frames: zero-velocity start
        self.velocity = lie.se3_identity(device=dev)
        self.last_kf_id = int(kf1)
        self.last_kf_tracked = int(torch.sum((mp_ids >= 0).to(torch.int32)))
        self._last_kf_tracked_dev = None
        self.frames_since_kf = 0
        self._cur_obs = obs1
        self._local_ba()

    # -- tracking ----------------------------------------------------------

    def _track_frame(self, feats, timestamp) -> FrameRecord:
        """One fused device step (TrackWithMotionModel + TrackLocalMap),
        then one small host read for the state-machine decisions."""
        cfg = self.cfg
        # advance in-flight background work by one chunk BEFORE the frame
        self._lba_tick()
        if (self.loop_closer is not None
                and self.loop_closer.pending_gba is not None):
            with stage("gba"):
                self.loop_closer.gba_tick(self)

        pred_pose = lie.se3_compose(self.velocity, self.cur_pose)
        # the step updates the counters in place: pass copies so the
        # reference-KF fallback restarts from the pre-frame counters
        vis_snap, fnd_snap = self.map.mp_visible, self.map.mp_found
        upd = self._frame_update(vis_snap.clone(), fnd_snap.clone(),
                                 self.cur_pose, pred_pose, feats)
        n_matches, n_inliers = upd.counts.tolist()

        if (n_matches < cfg.min_track_matches
                or n_inliers < cfg.min_track_matches // 2):
            # reference TrackReferenceKeyFrame fallback (tracking.cc:2043)
            self._lba_drain()
            rec_pose = self._track_reference_kf(feats)
            if rec_pose is not None:
                upd = self._frame_update(vis_snap.clone(), fnd_snap.clone(),
                                         self.cur_pose, rec_pose, feats)
                n_matches, n_inliers = upd.counts.tolist()
        self.map = self.map._replace(
            mp_visible=upd.mp_visible, mp_found=upd.mp_found)

        if (n_matches < cfg.min_track_matches
                or n_inliers < cfg.min_track_matches // 2):
            if self.state == TrackState.OK:
                self.lost_since = self.frame_id
            self.state = TrackState.LOST
            self.ref_feats = None
            return FrameRecord(timestamp, pred_pose,
                               min(n_matches, n_inliers), "lost")

        self._cur_obs = upd.obs
        self.last_pose = self.cur_pose
        self.cur_pose = upd.pose
        self.velocity = upd.velocity
        self.frames_since_kf += 1
        self._post_track_refine(feats, upd)

        if self._need_new_keyframe(n_inliers):
            self._ensure_capacity()
            with stage("keyframe_insert"):
                # _cur_obs, not upd.obs: a compaction remaps _cur_obs
                self._insert_keyframe(feats, timestamp, self._cur_obs)

        return FrameRecord(timestamp, self.cur_pose, n_inliers, "ok")

    def _frame_update(self, vis, fnd, prev_pose, pred_pose, feats):
        """The per-frame match + solve program: fused on one device
        (engine/step.py) or, on a mesh, map-sharded
        (parallel/dist_track.py)."""
        from .step import fused_frame_update

        cfg = self.cfg
        h, w = cfg.image_size
        if self.mesh is not None:
            return self._dist_frame_update(vis, fnd, prev_pose, pred_pose,
                                           feats)
        return fused_frame_update(
            self.map.mp_pos, self.map.mp_desc, self.map.mp_valid,
            vis, fnd, prev_pose, pred_pose,
            feats.uv, feats.desc, feats.valid, feats.octave,
            self.inv_s2, self.cam_params,
            mp_normal=self.map.mp_normal,
            mp_min_dist=self.map.mp_min_dist,
            mp_max_dist=self.map.mp_max_dist,
            cam_model=cfg.cam_model, img_h=h, img_w=w,
            radius_coarse=cfg.match_radius_coarse,
            radius_fine=cfg.match_radius_fine,
            min_matches=cfg.min_track_matches,
            far_threshold=cfg.th_far_points,
            num_levels=cfg.orb.num_levels)

    def _dist_frame_update(self, vis, fnd, prev_pose, pred_pose, feats):
        """Per-frame tracking with the map-point table sharded over the
        mesh (local matching per shard, summed normal equations, one pose
        update), adapted to the fused step's ``FrameUpdate``."""
        from ..parallel.dist_track import (distributed_frame_update,
                                           pad_map_for_mesh)
        from .step import FrameUpdate

        cfg = self.cfg
        h, w = cfg.image_size
        m = self.map
        inv_s2 = self.inv_s2[torch.clamp(
            feats.octave, 0, cfg.orb.num_levels - 1).long()]
        mp_pos, mp_desc, mp_valid, visp, fndp = pad_map_for_mesh(
            self.mesh, m.mp_pos, m.mp_desc, m.mp_valid, vis, fnd)
        res = distributed_frame_update(
            mp_pos, mp_desc, mp_valid, visp, fndp, prev_pose, pred_pose,
            feats.uv, feats.desc, feats.valid, inv_s2, self.cam_params,
            mesh=self.mesh, cam_model=cfg.cam_model, img_h=h, img_w=w,
            radius_coarse=cfg.match_radius_coarse,
            radius_fine=cfg.match_radius_fine)
        dev = self.device
        M = m.mp_pos.shape[0]
        F = feats.uv.shape[0]
        midx = res.match_idx[:M].to(dev)
        ok = res.inlier[:M].to(dev) & (midx >= 0)
        # several map points may take one keypoint: the last row wins, as
        # the reference's scatter does on the CPU
        obs = masked_set_last(
            torch.full((F,), -1, dtype=torch.int32, device=dev),
            torch.clamp(midx, 0, F - 1),
            torch.arange(M, dtype=torch.int32, device=dev), ok)
        pose = lie.SE3(res.pose.R.to(dev), res.pose.t.to(dev))
        velocity = lie.se3_compose(pose, lie.se3_inverse(prev_pose))
        return FrameUpdate(
            pose=pose, velocity=velocity, obs=obs,
            mp_visible=res.mp_visible[:M].to(dev),
            mp_found=res.mp_found[:M].to(dev), counts=res.counts.to(dev))

    def _track_reference_kf(self, feats) -> Optional[lie.SE3]:
        """Descriptor-only match against the reference keyframe + pose solve
        from the last frame's pose (reference TrackReferenceKeyFrame)."""
        kf = self.last_kf_id
        if kf < 0:
            return None
        from ..solver import pose_opt
        m = self.map
        kf_obs = m.kf_obs_mp[kf]
        kf_has_mp = m.kf_feat_valid[kf] & (kf_obs >= 0)
        mask = feats.valid[:, None] & kf_has_mp[None, :]
        # reference SearchByBoW: TH_LOW with a 0.7 ratio test
        idx, ok = matcher.match_masked(feats.desc, m.kf_desc[kf], mask,
                                       max_dist=matcher.TH_LOW, ratio=0.7)
        mp_rows = kf_obs[torch.clamp(idx, 0, kf_obs.shape[0] - 1).long()]
        valid = ok & (mp_rows >= 0)
        if int(torch.sum(valid.to(torch.int32))) < 15:
            return None
        pts = m.mp_pos[torch.clamp(mp_rows, 0, m.max_mp - 1).long()]
        inv_s2 = self.inv_s2[torch.clamp(
            feats.octave, 0, self.cfg.orb.num_levels - 1).long()]
        pose, _, n_in = pose_opt.pose_optimization(
            self.cur_pose, pts, feats.uv, inv_s2, valid, self.cam_params,
            cam_model=self.cfg.cam_model, rounds=4, iters_per_round=10)
        if int(n_in) < 10:
            return None
        return pose

    def _post_track_refine(self, feats, upd) -> None:
        """Hook: visual-only tracking needs no refinement."""

    def _need_new_keyframe(self, n_inliers: int) -> bool:
        """Reference Tracking::NeedNewKeyFrame (tracking.cc:2350), the
        visual-only conditions."""
        cfg = self.cfg
        if self._last_kf_tracked_dev is not None:
            self.last_kf_tracked = max(1, int(self._last_kf_tracked_dev))
            self._last_kf_tracked_dev = None
        if self.frames_since_kf < cfg.kf_min_interval:
            return False
        if self.frames_since_kf >= cfg.kf_max_interval:
            return True
        return n_inliers < cfg.kf_tracked_ratio * max(self.last_kf_tracked, 1)

    # -- capacity management ------------------------------------------------

    def _ensure_capacity(self) -> None:
        """Make room for one keyframe insert: compact culled slots first,
        double the tables if the live set itself is at capacity."""
        self._lba_drain()
        m = self.map
        if int(m.n_kf) >= m.max_kf:
            self._compact_keyframes()
            if int(self.map.n_kf) >= self.map.max_kf:
                new_k = self.map.max_kf * 2
                self.map = ms.grow_map(self.map, new_max_kf=new_k)
                self._on_kf_grow(new_k)
        # a keyframe insert creates at most ~2F new points
        need_mp = 2 * self.cfg.orb.n_features
        m = self.map
        if int(m.n_mp) + need_mp > m.max_mp:
            self._compact_map_points()
            if int(self.map.n_mp) + need_mp > self.map.max_mp:
                self.map = ms.grow_map(self.map,
                                       new_max_mp=self.map.max_mp * 2)

    def _compact_map_points(self) -> None:
        # point rows move under an in-flight GBA snapshot: abort it
        if self.loop_closer is not None:
            self.loop_closer.pending_gba = None
        self.map, old_to_new = ms.compact_map_points(self.map)
        if self._cur_obs is not None:
            o = self._cur_obs
            self._cur_obs = torch.where(
                o >= 0, old_to_new[torch.clamp(
                    o, 0, old_to_new.shape[0] - 1).long()],
                torch.full_like(o, -1))

    def _compact_keyframes(self) -> None:
        new_map, old_to_new, order = ms.compact_keyframes(self.map)
        o2n = old_to_new.cpu().numpy()
        # entries whose reference keyframe is dropped are frozen to
        # absolute poses against the OLD map (before the rows move)
        traj = []
        for ts, kf, T in self._traj_rel:
            if kf >= 0 and o2n[kf] < 0:
                traj.append((ts, -1, self._resolve_pose(kf, T)))
            elif kf >= 0:
                traj.append((ts, int(o2n[kf]), T))
            else:
                traj.append((ts, kf, T))
        self._traj_rel = traj
        self.map = new_map
        if self.last_kf_id >= 0:
            self.last_kf_id = int(o2n[self.last_kf_id])
        if self.loop_closer is not None:
            self.loop_closer.on_kf_remap(o2n, order.cpu().numpy())
        self._on_kf_remap(o2n, order.cpu().numpy())

    def _tri_covisible(self) -> int:
        """Covisible triangulation neighbour budget (hook)."""
        return int(getattr(self.cfg, "tri_covisible", 3))

    def _on_kf_remap(self, old_to_new, order) -> None:
        """Hook: subclasses permute their per-keyframe side tables."""

    def _on_kf_grow(self, new_max_kf: int) -> None:
        """Hook: subclasses grow their per-keyframe side tables."""
        if self.loop_closer is not None:
            self.loop_closer.on_kf_grow(new_max_kf)

    def _try_relocalize(self, feats) -> bool:
        """Relocalization against the active map (reference
        Tracking::Relocalization): BoW candidates, information-weighted
        PnP RANSAC, then the guided projection search at the coarse pose
        with an inlier quorum before the pose is accepted."""
        if self.loop_closer is None or int(self.map.n_kf) < 2:
            return False
        with stage("relocalize"):
            return self._relocalize(feats)

    def _relocalize(self, feats) -> bool:
        from ..solver.pnp import pnp_ransac
        cfg = self.cfg
        db = self.loop_closer.db
        q = db.compute_bow(feats.desc, feats.valid)
        ids, _ = db.query(q, torch.zeros(self.map.max_kf, dtype=torch.bool,
                                         device=self.device), top_k=3)
        inv_s2_all = self.inv_s2[torch.clamp(
            feats.octave, 0, cfg.orb.num_levels - 1).long()]
        # the reference's 50 good points at its ~1000-feature budget
        quorum = max(25, int(50 * min(1.0, cfg.orb.n_features / 1000.0)))
        for cand in ids.cpu().numpy():
            if cand < 0:
                continue
            cand = int(cand)
            m = self.map
            cand_has = m.kf_feat_valid[cand] & (m.kf_obs_mp[cand] >= 0)
            idx, ok = matcher.match_mutual(
                feats.desc, feats.valid, m.kf_desc[cand], cand_has,
                max_dist=matcher.TH_LOW)
            if int(torch.sum(ok.to(torch.int32))) < 15:
                continue
            idx_c = torch.clamp(idx, 0, m.n_feat - 1).long()
            mp_rows = torch.clamp(m.kf_obs_mp[cand][idx_c], 0,
                                  m.max_mp - 1).long()
            res = pnp_ransac(
                m.mp_pos[mp_rows], feats.uv, ok & m.mp_valid[mp_rows],
                self.cam_params, prng.PRNGKey(self.frame_id * 131 + cand),
                cam_model=cfg.cam_model, inv_sigma2=inv_s2_all)
            if not bool(res.ok):
                continue
            # guided retry over the whole map at the coarse pose
            upd = self._frame_update(m.mp_visible.clone(),
                                     m.mp_found.clone(), res.pose, res.pose,
                                     feats)
            _, n_i = upd.counts.tolist()
            if n_i < quorum:
                continue
            self.cur_pose = res.pose
            self.velocity = lie.se3_identity(device=self.device)
            self.state = TrackState.OK
            return True
        return False

    # -- mapping -----------------------------------------------------------

    def _insert_keyframe(self, feats, timestamp, obs):
        """KF insert + triangulation + fusion + culling as one device
        program (engine/mapping.py), keyframe culling, then local BA."""
        from .mapping import mapping_step, top_covisible

        # mapping is a structural change: land the in-flight BA first
        self._lba_drain()
        cfg = self.cfg
        h, w = cfg.image_size
        dev = self.device
        n_kf_before = int(self.map.n_kf)
        prev = np.full(3, -1, np.int32)
        ids = list(range(n_kf_before - 1, max(-1, n_kf_before - 4), -1))
        prev[: len(ids)] = ids
        n_cov = self._tri_covisible()
        prev_ids = torch.from_numpy(prev).to(dev)
        if n_cov > 0 and n_kf_before > 3:
            cov = top_covisible(self.map, obs, max(0, n_kf_before - 3),
                                k=n_cov)
            prev_ids = torch.cat([prev_ids, cov])

        res = mapping_step(
            self.map, self.cur_pose, timestamp, feats.uv, feats.desc,
            feats.octave, feats.valid, obs, prev_ids,
            self.cam_params, cam_model=cfg.cam_model, img_h=h, img_w=w,
            n_prev=int(prev_ids.shape[0]),
            culling_found_ratio=cfg.culling_found_ratio,
            far_threshold=cfg.th_far_points,
            num_levels=cfg.orb.num_levels)
        self.map = res.map
        # no host sync on the mapping result: _ensure_capacity guaranteed
        # the slot, and the tracked count is read by the next frame
        kf_id = n_kf_before
        self._last_kf_tracked_dev = res.stats[1]

        self._cull_keyframes()
        self.last_kf_id = kf_id
        self.frames_since_kf = 0
        self._local_ba()

        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(kf_id, feats.desc, feats.valid)
            with stage("loop_closing"):
                self.loop_closer.try_close(self)
            if self.enable_atlas and len(self.atlas) > 0:
                with stage("merge"):
                    self._try_merge_maps(feats)

    def _try_merge_maps(self, feats) -> bool:
        """Cross-map place recognition and merge (reference
        NewDetectCommonRegions -> MergeLocal): the newest keyframe queries
        every archived map's BoW matrix; a Sim3-verified hit welds the
        active map into the archived one."""
        from ..place.database import _query
        if self._merge_cooldown > 0:
            self._merge_cooldown -= 1
            return False
        if int(self.map.n_kf) < 5:
            return False
        cur = self.last_kf_id
        m = self.map
        q = self.loop_closer.db.compute_bow(m.kf_desc[cur],
                                            m.kf_feat_valid[cur])
        for ai, arch in enumerate(self.atlas.archived):
            ids, _ = _query(arch.bow, arch.present, q,
                            torch.zeros_like(arch.present), 2)
            for cand in ids.cpu().numpy():
                if cand < 0:
                    continue
                if self._verify_and_merge(feats, int(cand), ai):
                    return True
        self._merge_cooldown = 5
        return False

    def _verify_and_merge(self, feats, cand: int, archive_idx: int) -> bool:
        from ..solver.local_ba import local_ba_step
        from ..solver.sim3 import optimize_sim3, sim3_ransac
        dev = self.device
        cur = self.last_kf_id
        m_new = self.map
        m_old = self.atlas.archived[archive_idx].map
        F = m_new.n_feat

        cand_has = m_old.kf_feat_valid[cand] & (m_old.kf_obs_mp[cand] >= 0)
        cur_has = m_new.kf_feat_valid[cur] & (m_new.kf_obs_mp[cur] >= 0)
        idx, ok = matcher.match_mutual(
            m_old.kf_desc[cand], cand_has, m_new.kf_desc[cur], cur_has,
            max_dist=matcher.TH_LOW)
        if int(torch.sum(ok.to(torch.int32))) < 20:
            return False
        idx_c = torch.clamp(idx, 0, F - 1).long()
        mp_old = torch.clamp(m_old.kf_obs_mp[cand], 0,
                             m_old.max_mp - 1).long()
        mp_new_row = m_new.kf_obs_mp[cur][idx_c]
        mp_new = torch.clamp(mp_new_row, 0, m_new.max_mp - 1).long()
        pair_ok = ok & (mp_new_row >= 0)
        pose_old = _pose_at(m_old, cand)
        pose_new = _pose_at(m_new, cur)
        x1 = lie.se3_apply(pose_old, m_old.mp_pos[mp_old])
        x2 = lie.se3_apply(pose_new, m_new.mp_pos[mp_new])
        uv1 = m_old.kf_uv[cand]
        uv2 = m_new.kf_uv[cur][idx_c]
        # both-metric welds (stereo rigs, initialized inertial) fix scale
        fix_scale = hasattr(self, "kf_uright") or bool(
            getattr(self, "imu_initialized", False))
        res = sim3_ransac(
            x1, x2, pair_ok, uv1, uv2, self.cam_params,
            prng.PRNGKey(cur * 31 + cand), fix_scale=fix_scale,
            min_inliers=15, cam_model=self.cfg.cam_model)
        if not bool(res.ok):
            return False
        ones = torch.ones(F, dtype=torch.float32, device=dev)
        S_c, _, n_in = optimize_sim3(
            res.sim, x1, x2, pair_ok, uv1, uv2, ones, ones, self.cam_params,
            fix_scale=fix_scale, cam_model=self.cfg.cam_model)
        if int(n_in) < 20:
            return False

        # x_newcam = S_c(x_oldcam): S_{old_w -> new_w} =
        # pose_new^-1 o S_c o pose_old
        S_old_to_new = lie.sim3_compose(
            lie.sim3_from_se3(lie.se3_inverse(pose_new)),
            lie.sim3_compose(S_c, lie.sim3_from_se3(pose_old)))
        S_new_to_old = lie.sim3_inverse(S_old_to_new)

        # grow the receiving map first if the weld would overflow it
        need_kf = int(m_old.n_kf) + int(m_new.n_kf)
        need_mp = int(m_old.n_mp) + int(m_new.n_mp)
        if need_kf > m_old.max_kf or need_mp > m_old.max_mp:
            gk = m_old.max_kf
            while gk < need_kf:
                gk *= 2
            gm = m_old.max_mp
            while gm < need_mp:
                gm *= 2
            m_old = ms.grow_map(m_old, new_max_kf=gk, new_max_mp=gm)
        merged, kf_off, _ = merge_maps(m_old, m_new, S_new_to_old)
        if merged is None:
            return False

        arch = self.atlas.archived.pop(archive_idx)
        self.map = merged
        self._traj_rel = [(ts, kf + kf_off if kf >= 0 else kf, T)
                          for ts, kf, T in self._traj_rel]
        self.last_kf_id = cur + kf_off
        C = -torch.einsum("ji,j->i", pose_new.R, pose_new.t)
        C2 = lie.sim3_apply(S_new_to_old, C)
        R2 = pose_new.R @ S_new_to_old.R.T
        self.cur_pose = lie.SE3(R2, -(R2 @ C2))
        self.velocity = lie.se3_identity(device=dev)
        # the BoW database: archived rows + the active map's rows shifted
        db = self.loop_closer.db
        n_new = int(m_new.n_kf)
        arch_bow, arch_present = arch.bow, arch.present
        if arch_bow.shape[0] < self.map.max_kf:
            pad = self.map.max_kf - arch_bow.shape[0]
            arch_bow = torch.cat([arch_bow, torch.zeros(
                (pad, arch_bow.shape[1]), dtype=arch_bow.dtype,
                device=dev)])
            arch_present = torch.cat([arch_present, torch.zeros(
                pad, dtype=torch.bool, device=dev)])
        bow = arch_bow.clone()
        bow[kf_off:kf_off + n_new] = db.bow[:n_new]
        present = arch_present.clone()
        present[kf_off:kf_off + n_new] = db.present[:n_new]
        db.bow, db.present = bow, present
        # loop bookkeeping follows the index shift; solves in flight and
        # the deferred detection saw the old rows
        lc = self.loop_closer
        lc.loop_edges = [(i + kf_off, j + kf_off, rel)
                         for i, j, rel in lc.loop_edges]
        lc._cons_groups = []
        lc.pending_gba = None
        lc._pending_detect = None
        self._pending_lba = None
        if lc.last_loop_kf >= 0:
            lc.last_loop_kf += kf_off
        # per-keyframe side tables follow the weld
        self._on_maps_merged(arch, kf_off, S_new_to_old)

        # welding BA (reference MergeLocal's LocalBundleAdjustment): the
        # welded-in keyframes nearest the seam against the anchored
        # old-map neighbourhood of the candidate
        cfg = self.cfg
        W = cfg.ba_window + cfg.ba_fixed_ring
        n_total = int(self.map.n_kf)
        old_side = list(range(max(0, cand - 2), min(kf_off, cand + 3)))
        new_side = list(range(max(kf_off, n_total - (W - len(old_side))),
                              n_total))
        window = np.full(W, -1, np.int32)
        ids = (old_side + new_side)[:W]
        window[: len(ids)] = ids
        fixed = np.zeros(W, bool)
        fixed[: len(old_side)] = True
        fixed |= window < 0
        self.map, _, _ = local_ba_step(
            self.map, torch.from_numpy(window).to(dev),
            torch.from_numpy(fixed).to(dev), self.inv_s2, self.cam_params,
            cam_model=cfg.cam_model, iters_first=cfg.ba_iters_first,
            iters_second=cfg.ba_iters_second)
        self.cur_pose = _pose_at(self.map, self.last_kf_id)
        self._reset_prior()
        self._merge_cooldown = 20
        return True

    def _cull_keyframes(self):
        """Drop redundant keyframes (reference KeyFrameCulling,
        localmapping.cc:791): a keyframe whose points are > 90% seen by
        >= 3 other keyframes at the same or a finer scale is removed, one
        at a time with live counts, over the recent window (sparing the
        newest two and the first)."""
        m = self.map
        n_kf = int(m.n_kf)
        if n_kf < 6:
            return
        memb = ms.observation_mask(m).cpu().numpy()       # (K, M) copy
        obs = m.kf_obs_mp.cpu().numpy()
        octv = m.kf_octave.cpu().numpy()
        kf_valid = m.kf_valid.cpu().numpy()
        K = obs.shape[0]
        oct_of = np.full((K, memb.shape[1]), 99, np.int16)
        kk, ff = np.nonzero(obs >= 0)
        oct_of[kk, obs[kk, ff]] = octv[kk, ff]
        oct_of[~memb] = 99
        culled = []
        for k in range(max(1, n_kf - 10), n_kf - 2):
            if not (bool(kf_valid[k]) and self._can_cull(k)):
                continue
            mk = memb[k]
            n_pts = max(int(mk.sum()), 1)
            finer = ((oct_of <= oct_of[k][None, :] + 1) & memb).sum(axis=0)
            n_red = int((mk & (finer >= 4)).sum())
            if n_red / n_pts > 0.9:
                culled.append(k)
                memb[k] = False
                oct_of[k] = 99
        if culled:
            if self.loop_closer is not None:
                for k in culled:
                    self.loop_closer.db.remove(k)
            rows = torch.tensor(culled, dtype=torch.long, device=self.device)
            kv = self.map.kf_valid.clone()
            kv[rows] = False
            kfo = self.map.kf_obs_mp.clone()
            kfo[rows] = -1
            self.map = self.map._replace(kf_valid=kv, kf_obs_mp=kfo)

    def _reset_prior(self) -> None:
        """Hook: inertial trackers restart their marginalization chain."""

    def _inertial_archive_snapshot(self):
        """Hook: inertial trackers return their per-keyframe side tables
        for the atlas archive (None: a visual map)."""
        return None

    def _on_maps_merged(self, arch, kf_off: int,
                        S_new_to_old: lie.Sim3) -> None:
        """Hook: subclasses rebuild their per-keyframe side tables after
        the active map was welded into an archived one."""

    def _can_cull(self, k: int) -> bool:
        """Hook: the inertial mixin vetoes culls that open long gaps."""
        return True

    def _ba_window_arrays(self, min_fixed: int):
        """Host-side window + fixed-mask construction for local BA: the
        newest keyframe, its temporal predecessors and its best covisible
        keyframes optimized, the next ``ba_fixed_ring`` held fixed with
        their factors (reference LocalBundleAdjustment, optimizer.cc:
        1053-1096)."""
        cfg = self.cfg
        n_kf = int(self.map.n_kf)
        W = cfg.ba_window + cfg.ba_fixed_ring
        if not self.ba_covisible_window:
            start = max(0, n_kf - W)
            window = np.full(W, -1, np.int32)
            ids = np.arange(start, n_kf, dtype=np.int32)
            window[: len(ids)] = ids
            n_in = len(ids)
            n_fixed = max(n_in - cfg.ba_window, min(min_fixed, n_in - 1))
            fixed = np.zeros(W, bool)
            fixed[:n_fixed] = True
            fixed |= window < 0
            return window, fixed, n_in, n_fixed
        cur = self.last_kf_id if 0 <= self.last_kf_id < n_kf else n_kf - 1
        chosen = [k for k in (cur, cur - 1, cur - 2) if k >= 0]
        if n_kf > len(chosen):
            Wc = ms.covisibility_matrix(self.map)[cur, :n_kf].cpu().numpy()
            live = self.map.kf_valid[:n_kf].cpu().numpy()
            Wc = np.where(live, Wc, -1)
            order = np.argsort(-Wc)
            extra = [int(k) for k in order
                     if Wc[k] > 0 and k not in chosen]
        else:
            extra = []
        opt_ids = (chosen + extra)[: cfg.ba_window]
        ring = [k for k in extra if k not in opt_ids]
        t = min(opt_ids) - 1 if opt_ids else -1
        while len(ring) < cfg.ba_fixed_ring and t >= 0:
            if t not in opt_ids and t not in ring:
                ring.append(t)
            t -= 1
        ring = ring[: cfg.ba_fixed_ring]
        n_in = len(opt_ids) + len(ring)
        need = max(0, min(min_fixed, n_in - 1) - len(ring))
        opt_sorted = sorted(opt_ids)
        forced_fixed = set(opt_sorted[:need])
        ids = sorted(set(opt_ids) | set(ring))
        window = np.full(W, -1, np.int32)
        fixed = np.zeros(W, bool)
        window[: len(ids)] = ids
        for i, k in enumerate(ids):
            fixed[i] = (k in ring) or (k in forced_fixed)
        fixed |= window < 0
        n_fixed = int(fixed[: len(ids)].sum())
        return window, fixed, len(ids), n_fixed

    # -- background local BA protocol ---------------------------------------

    def _start_background_lba(self, window, fixed, n_in: int) -> bool:
        """Start a chunked background local BA once the map is past its
        warm-up; the robust phase runs now, the polish over the next
        frames. Returns True when started."""
        if (self.mesh is not None
                or not getattr(self.cfg, "background_lba", True)
                or n_in < 5):
            return False
        self._lba_drain()   # at most one solve in flight
        self._pending_lba = ChunkedLocalBA(self, window, fixed)
        self._lba_tick()
        return True

    def _lba_tick(self) -> None:
        """Advance the in-flight background LBA by one chunk and scatter
        the estimates into the live map from the phase-0 boundary on; a
        polish chunk that still moves the window drains the solve."""
        p = self._pending_lba
        if p is None:
            return
        done = p.lm.step()
        moved = False
        if done or p.lm.phase >= 1:
            moved = self._scatter_lba(p, final=done)
            first = not p.scattered
            p.scattered = True
        if done:
            self._pending_lba = None
        elif moved and not first:
            self._lba_drain()

    def _lba_drain(self) -> None:
        while self._pending_lba is not None:
            self._lba_tick()

    def _scatter_lba(self, p, final: bool) -> bool:
        """Write the background solve's estimates into the live map and
        keep the live camera's pose relative to the newest optimized
        keyframe; ``final`` also unbinds the solve's chi2 outliers.
        Returns True when this scatter moved the newest keyframe."""
        m = self.map
        lm = p.lm
        win_ok = p.win >= 0
        kf_R = masked_set(m.kf_pose.R, p.win, lm.poses.R, win_ok)
        kf_t = masked_set(m.kf_pose.t, p.win, lm.poses.t, win_ok)
        kfo = m.kf_obs_mp
        if final:
            inl = ba_mod.inlier_mask(lm.poses, lm.points, lm.prob,
                                     lm.cam_model)
            W = p.win.shape[0]
            drop = (p.valid & ~inl).reshape(W, m.n_feat)
            rows = kfo[p.wclip]
            kfo = masked_set(kfo, p.win,
                             torch.where(drop, torch.full_like(rows, -1),
                                         rows), win_ok)
        self.map = m._replace(
            kf_pose=lie.SE3(kf_R, kf_t),
            mp_pos=torch.where(m.mp_valid[:, None], lm.points, m.mp_pos),
            kf_obs_mp=kfo)
        k = p.newest_kf
        if k >= 0 and k == self.last_kf_id and p.old_newest is not None:
            # Rounding discipline (reference tracker.py:1236-1260): the
            # shift composes near-cancelling transforms, so a no-op chunk
            # shifts nothing and a pose still AT the old estimate adopts
            # the refined one exactly.
            T_new = lie.SE3(kf_R[k], kf_t[k])
            R_new, t_new = _host(T_new)
            R_old, t_old = _host(p.old_newest)
            if np.array_equal(R_new, R_old) and np.array_equal(t_new, t_old):
                return False  # chunk accepted no step: nothing moved
            R_cur, t_cur = _host(self.cur_pose)
            if np.array_equal(R_cur, R_old) and np.array_equal(t_cur, t_old):
                self.cur_pose = T_new
            else:
                rel = lie.se3_compose(self.cur_pose,
                                      lie.se3_inverse(p.old_newest))
                self.cur_pose = keep_on_so3(lie.se3_compose(rel, T_new))
            p.old_newest = T_new
            return True
        return False

    def _local_ba(self):
        """Windowed local BA: background chunks once past the warm-up,
        else one synchronous solve (solver/local_ba.py)."""
        from ..solver.local_ba import local_ba_step

        cfg = self.cfg
        # monocular: at least the oldest two fixed for the 7-DoF gauge
        window, fixed, n_in, n_fixed = self._ba_window_arrays(min_fixed=2)
        if self.mesh is not None:
            return self._local_ba_dist(window, fixed)
        if self._start_background_lba(window, fixed, n_in):
            return
        with stage("local_ba"):
            self.map, costs, n_edges = local_ba_step(
                self.map, torch.from_numpy(window).to(self.device),
                torch.from_numpy(fixed).to(self.device), self.inv_s2,
                self.cam_params, cam_model=cfg.cam_model,
                iters_first=cfg.ba_iters_first,
                iters_second=cfg.ba_iters_second)
        if STAGES.enabled:
            STAGES.bump("num_OptKF_BA", max(0, n_in - n_fixed))
            STAGES.bump("num_edges_BA", int(n_edges))
        if self.last_kf_id >= 0 and n_in > 0:
            self.cur_pose = _pose_at(self.map, self.last_kf_id)

    def _local_ba_dist(self, window, fixed):
        """Windowed local BA through the landmark-sharded distributed Schur
        reduction: the window's observation triples become a general-layout
        problem over the window's pose rows (``observation_triples``'
        ``kf_idx`` is window-relative); non-window poses stay fixed."""
        from ..parallel.dist_ba import distributed_bundle_adjustment

        cfg = self.cfg
        m = self.map
        dev = self.device
        win = torch.from_numpy(window).to(dev)
        fix = torch.from_numpy(fixed).to(dev)
        kf_idx, mp_idx, uv, octv, valid = ms.observation_triples(m, win)
        inv_s2 = self.inv_s2[torch.clamp(
            octv, 0, cfg.orb.num_levels - 1).long()]
        win_c = torch.clamp(win, 0, m.max_kf - 1).long()
        win_poses = lie.SE3(m.kf_pose.R[win_c], m.kf_pose.t[win_c])
        prob = ba_mod.make_problem(
            win_poses, m.mp_pos, kf_idx, mp_idx, uv, inv_s2, valid, fix,
            self.cam_params, fixed_point=~m.mp_valid, max_obs=16)
        with stage("local_ba"):
            new_poses, new_points, _ = distributed_bundle_adjustment(
                prob, self.mesh, cam_model=cfg.cam_model,
                iters=cfg.ba_iters_first + cfg.ba_iters_second)
        ok_w = (win >= 0) & ~fix
        kf_R = masked_set(m.kf_pose.R, win_c, new_poses.R.to(dev), ok_w)
        kf_t = masked_set(m.kf_pose.t, win_c, new_poses.t.to(dev), ok_w)
        self.map = m._replace(
            kf_pose=lie.SE3(kf_R, kf_t),
            mp_pos=torch.where(m.mp_valid[:, None], new_points.to(dev),
                               m.mp_pos))
        if self.last_kf_id >= 0:
            self.cur_pose = _pose_at(self.map, self.last_kf_id)

    # -- output ------------------------------------------------------------

    def trajectory_tum(self) -> np.ndarray:
        """(N, 8) array: timestamp, tx ty tz, qx qy qz qw (Twc convention,
        reference System::SaveTrajectoryTUM, system.cc:558)."""
        rows = []
        for ts, Tcw in self.resolved_poses():
            Twc = lie.se3_inverse(Tcw)
            q = lie.quat_from_mat(Twc.R).cpu().numpy()   # (w,x,y,z)
            t = Twc.t.cpu().numpy()
            rows.append([ts, t[0], t[1], t[2], q[1], q[2], q[3], q[0]])
        return np.asarray(rows)
