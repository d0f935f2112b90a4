"""Stereo, RGB-D and fisheye-stereo sessions.

Counterpart of ``orb_slam_fusion_tpu/engine/stereo_tracker.py``: the same
``MonoTracker`` per-frame programs (so every tracked frame launches the
masked-match kernel three times) plus the metric-scale parts of the
reference's Tracking::StereoInitialization (instant bootstrap from
disparity depth, tracking.cc:1681), stereo point creation at keyframes
(CreateNewKeyFrame) and the stereo factor of local BA
(EdgeStereoSE3ProjectXYZ). A per-keyframe table ``kf_uright`` (K, F) holds
each feature's right-image u (-1 for a monocular observation).

RGB-D turns each feature's depth into a virtual right-image u =
u_L - bf/z (Frame::ComputeStereoFromRGBD); the fisheye rig triangulates
its left/right matches through the extrinsics and feeds that depth the
same way. After a map merge (``_on_maps_merged``) the active map's
right-u rows move to their welded rows and the archived map's rows fall
back to monocular observations, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import lie
from ..frontend import extractor
from ..frontend.stereo import (depth_from_disparity, fisheye_stereo_match,
                               stereo_match, subpixel_refine)
from ..map import map_state as ms
from ..utils.timing import stage
from .config import SlamConfig
from .tracker import FrameRecord, MonoTracker, TrackState, _pose_at


class StereoTracker(MonoTracker):
    """Stereo SLAM session (rectified pair, shared intrinsics)."""

    # metric scale from the baseline: the contiguous temporal window
    ba_covisible_window = False

    def __init__(self, config: SlamConfig, baseline: float, device=None):
        super().__init__(config, device)
        self.baseline = float(baseline)
        self.bf = float(baseline) * float(config.cam_params[0])
        self.kf_uright = torch.full(
            (config.max_keyframes, config.orb.n_features), -1.0,
            dtype=torch.float32, device=self.device)
        self._cur_uright = None
        self._cur_has_stereo = None
        self.min_stereo_points = 50

    # -- public API --------------------------------------------------------

    def process_stereo_features(self, featsL: extractor.Features,
                                featsR: extractor.Features,
                                timestamp: float, images=None
                                ) -> FrameRecord:
        """One rectified pair of feature sets; with ``images`` (the
        rectified left and right images) the disparities get the SAD
        subpixel refinement."""
        u_right, has_stereo = stereo_match(featsL, featsR)
        if images is not None:
            u_right, has_stereo = subpixel_refine(
                images[0], images[1], featsL.uv, u_right, has_stereo)
        return self._stereo_frame(featsL, u_right, has_stereo, timestamp)

    def process_stereo_images(self, imgL, imgR, timestamp: float
                              ) -> FrameRecord:
        """One rectified image pair ((H, W) tensors or arrays)."""
        imgL, imgR = self._image(imgL), self._image(imgR)
        with stage("orb_extract"):
            fL = extractor.extract_features(imgL, self.cfg.orb)
            fR = extractor.extract_features(imgR, self.cfg.orb)
        return self.process_stereo_features(fL, fR, timestamp,
                                            images=(imgL, imgR))

    def _stereo_frame(self, feats, u_right, has_stereo, timestamp
                      ) -> FrameRecord:
        self._cur_uright = u_right
        self._cur_has_stereo = has_stereo
        if self.state in (TrackState.NO_IMAGES, TrackState.NOT_INITIALIZED):
            with stage("initialize"):
                rec = self._stereo_initialize(feats, timestamp)
            self.frame_id += 1
            self._append_record(rec)
            return rec
        return self.process_features(feats, timestamp)

    # -- initialization ----------------------------------------------------

    def _bootstrap(self, feats, timestamp) -> FrameRecord:
        """Re-initialization after a reset: instant, from this frame's
        disparities."""
        if self._cur_uright is None:
            return super()._bootstrap(feats, timestamp)
        return self._stereo_initialize(feats, timestamp)

    def _stereo_initialize(self, feats, timestamp) -> FrameRecord:
        """Instant bootstrap: every stereo feature becomes a map point."""
        cfg = self.cfg
        dev = self.device
        z = depth_from_disparity(feats.uv[:, 0], self._cur_uright, self.bf,
                                 self._cur_has_stereo)
        good = (self._cur_has_stereo & feats.valid & (z > 0.1)
                & (z < 40.0 * self.baseline * 100))
        if int(torch.sum(good.to(torch.int32))) < self.min_stereo_points:
            return FrameRecord(timestamp, self.cur_pose, 0, "init-fail")

        X_w = self._rays(feats.uv) * z[:, None]   # world = first camera
        pose0 = lie.se3_identity(device=dev)
        dist = ms.vec_norm(X_w)
        normals = X_w / torch.clamp(dist[:, None], min=1e-9)
        min_d, max_d = ms.scale_invariance_band(dist, feats.octave,
                                                cfg.orb.num_levels)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        self.map, mp_ids = ms.add_map_points(
            self.map, X_w, feats.desc, normals, zero, zero, good,
            min_dist=min_d, max_dist=max_d)
        self.map, kf0 = ms.add_keyframe(
            self.map, pose0, timestamp, feats.uv, feats.desc, feats.octave,
            feats.valid, mp_ids)
        self.kf_uright[0] = self._uright_row()

        self.cur_pose = pose0
        self.last_pose = pose0
        self.velocity = lie.se3_identity(device=dev)
        self.last_kf_id = int(kf0)
        self.last_kf_tracked = int(torch.sum((mp_ids >= 0).to(torch.int32)))
        self._last_kf_tracked_dev = None
        self.frames_since_kf = 0
        self.state = TrackState.OK
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(0, feats.desc, feats.valid)
        return FrameRecord(timestamp, pose0, self.last_kf_tracked,
                           "init-done")

    def _uright_row(self) -> torch.Tensor:
        return torch.where(self._cur_has_stereo, self._cur_uright,
                           torch.full_like(self._cur_uright, -1.0))

    def reset_map(self):
        """Start a fresh map; the right-u table is cleared with it (a stale
        row would feed the new map's first solves wrong stereo factors)."""
        super().reset_map()
        self.kf_uright = torch.full_like(self.kf_uright, -1.0)

    # -- capacity hooks ------------------------------------------------------

    def _on_kf_remap(self, old_to_new, order):
        super()._on_kf_remap(old_to_new, order)
        self.kf_uright = self.kf_uright[
            torch.as_tensor(np.asarray(order), dtype=torch.long,
                            device=self.device)]

    def _on_kf_grow(self, new_max_kf: int):
        super()._on_kf_grow(new_max_kf)
        K, F = self.kf_uright.shape
        if new_max_kf > K:
            self.kf_uright = torch.cat(
                [self.kf_uright,
                 torch.full((new_max_kf - K, F), -1.0, dtype=torch.float32,
                            device=self.device)], dim=0)

    def _on_maps_merged(self, arch, kf_off: int, S_new_to_old):
        """Shift the right-u rows to the welded index space; the archived
        map's rows become monocular (-1): the archive keeps no u_right."""
        super()._on_maps_merged(arch, kf_off, S_new_to_old)
        K = self.map.max_kf
        F = self.kf_uright.shape[1]
        n_new = int(self.map.n_kf) - kf_off
        merged = torch.full((K, F), -1.0, dtype=torch.float32,
                            device=self.device)
        merged[kf_off:kf_off + n_new] = self.kf_uright[:n_new]
        self.kf_uright = merged

    # -- keyframe insertion ------------------------------------------------

    def _insert_keyframe(self, feats, timestamp, obs):
        """Stereo keyframe insert: unmatched stereo features become points
        at once (reference CreateNewKeyFrame), then the usual multi-view
        triangulation; the keyframe's right-u row is written after its
        insert-time local BA, as the reference writes it."""
        cfg = self.cfg
        kf_id_expected = int(self.map.n_kf)
        u_right = self._cur_uright
        has_stereo = self._cur_has_stereo

        if u_right is not None:
            z = depth_from_disparity(feats.uv[:, 0], u_right, self.bf,
                                     has_stereo)
            new_mask = (has_stereo & feats.valid & (obs < 0)
                        & (z > 0.1) & (z < 30.0))
            X_c = self._rays(feats.uv) * z[:, None]
            Twc = lie.se3_inverse(self.cur_pose)
            X_w = lie.se3_apply(Twc, X_c)
            dist = ms.vec_norm(X_c)
            normals = X_w - Twc.t
            normals = normals / torch.clamp(ms.vec_norm(normals)[:, None],
                                            min=1e-9)
            min_d, max_d = ms.scale_invariance_band(dist, feats.octave,
                                                    cfg.orb.num_levels)
            kf = torch.tensor(kf_id_expected, dtype=torch.int32,
                              device=self.device)
            self.map, new_ids = ms.add_map_points(
                self.map, X_w, feats.desc, normals, kf, kf, new_mask,
                min_dist=min_d, max_dist=max_d)
            obs = torch.where(new_ids >= 0, new_ids, obs)

        super()._insert_keyframe(feats, timestamp, obs)
        if self.last_kf_id == kf_id_expected and u_right is not None:
            self.kf_uright[kf_id_expected] = self._uright_row()

    # -- local BA with stereo residuals -----------------------------------

    def _local_ba(self):
        """Windowed local BA with 3-row stereo factors; metric scale needs
        only one fixed anchor keyframe."""
        from ..solver.local_ba import local_ba_step

        cfg = self.cfg
        window, fixed, n_in, _ = self._ba_window_arrays(min_fixed=1)
        if self._start_background_lba(window, fixed, n_in):
            return
        with stage("local_ba"):
            self.map, costs, n_edges = local_ba_step(
                self.map, torch.from_numpy(window).to(self.device),
                torch.from_numpy(fixed).to(self.device), self.inv_s2,
                self.cam_params, kf_uright=self.kf_uright, bf=self.bf,
                cam_model=cfg.cam_model, iters_first=cfg.ba_iters_first,
                iters_second=cfg.ba_iters_second)
        if self.last_kf_id >= 0 and n_in > 0:
            self.cur_pose = _pose_at(self.map, self.last_kf_id)


class RgbdTracker(StereoTracker):
    """RGB-D session: each feature's depth becomes a virtual right-image
    u = u_L - bf/z (reference Frame::ComputeStereoFromRGBD), after which
    the stereo machinery applies unchanged."""

    def process_rgbd_features(self, feats: extractor.Features,
                              depth: torch.Tensor, timestamp: float
                              ) -> FrameRecord:
        """``depth``: (N,) metric depth per feature (<= 0: none)."""
        depth = torch.as_tensor(depth, dtype=torch.float32,
                                device=feats.uv.device)
        has = feats.valid & (depth > 0.05)
        d = torch.clamp(depth, min=float(np.float32(1e-6)))
        u_right = torch.where(
            has, feats.uv[:, 0] - torch.full_like(d, self.bf) / d,
            torch.full_like(depth, -1.0))
        return self._stereo_frame(feats, u_right, has, timestamp)

    def process_rgbd_images(self, img, depth_img, timestamp: float
                            ) -> FrameRecord:
        """An (H, W) intensity image and its registered depth image: depth
        is sampled at the raw keypoint position (nearest pixel), geometry
        then uses the undistorted coordinates (the reference Frame's RGB-D
        order)."""
        img, depth_img = self._image(img), self._image(depth_img)
        with stage("orb_extract"):
            feats = extractor.extract_features(img, self.cfg.orb)
        h, w = depth_img.shape
        xi = torch.clamp(torch.round(feats.uv[:, 0]).to(torch.int64), 0,
                         w - 1)
        yi = torch.clamp(torch.round(feats.uv[:, 1]).to(torch.int64), 0,
                         h - 1)
        return self.process_rgbd_features(self._undistort(feats),
                                          depth_img[yi, xi], timestamp)


class FisheyeStereoTracker(RgbdTracker):
    """Stereo-fisheye session (two Kannala-Brandt 8 cameras, a TUM-VI
    style rig): left/right association is one masked Hamming match inside
    the lapping column ranges, the matched rays are triangulated through
    the extrinsics (``fisheye_stereo_match``), and the resulting depth
    drives the RGB-D machinery (reference ComputeStereoFishEyeMatches,
    frame.cc:1134+)."""

    def __init__(self, config: SlamConfig, cam2_params, T_c1_c2,
                 lapping1=None, lapping2=None, device=None):
        T12 = np.asarray(T_c1_c2, np.float64)
        super().__init__(config, float(np.linalg.norm(T12[:3, 3])), device)
        dev = self.device
        self.cam2_params = torch.tensor(np.asarray(cam2_params, np.float32),
                                        device=dev)
        T21 = np.linalg.inv(T12)
        self.R21 = torch.tensor(T21[:3, :3].astype(np.float32), device=dev)
        self.t21 = torch.tensor(T21[:3, 3].astype(np.float32), device=dev)
        w = config.image_size[1]
        self.lap1 = tuple(lapping1) if lapping1 else (0.0, float(w))
        self.lap2 = tuple(lapping2) if lapping2 else (0.0, float(w))

    def process_stereo_features(self, featsL: extractor.Features,
                                featsR: extractor.Features,
                                timestamp: float) -> FrameRecord:
        """One fisheye pair of feature sets. The inherited
        ``process_stereo_images`` raises a TypeError here, as the JAX
        package's does: its SAD refinement needs rectified rows."""
        depth, _ = fisheye_stereo_match(
            featsL, featsR, self.cam_params, self.cam2_params, self.R21,
            self.t21, self.lap1, self.lap2)
        return self.process_rgbd_features(featsL, depth, timestamp)
