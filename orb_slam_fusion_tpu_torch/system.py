"""System facade: the top-level user API.

Counterpart of ``orb_slam_fusion_tpu/system.py`` (the reference's ``System``
class, include/system.h:76-267 / src/system.cc): construct from a settings
file and a sensor type, feed frames with ``track_monocular`` /
``track_stereo`` / ``track_rgbd`` (and the IMU overloads), switch
localization-only mode, save trajectories in three formats, and checkpoint
and restore the atlas with a vocabulary guard. The trackers are the
port's; everything runs on ``device`` (CUDA unless named).

Frames go through the reference's preprocessing with its bits: the colour
conversion ``img @ [0.299, 0.587, 0.114]`` is, as XLA:CPU compiles the
reference's dot of 3, a chain of fused multiply-adds over the channels in
order; the resize is ``frontend/pyramid.py::resize_bilinear``, which
reproduces the reference's weights and dot schedule at every size but
one named class, a side of one pixel (ROADMAP C3). That schedule follows
the size of XLA's thread pool; the port reproduces the 8-thread regime of
the reference's tests and goldens (``pyramid.REFERENCE_THREADS``;
tests/torch_pyramid_probe.py --step HxW:hxw probes a frame resize).
"""

from __future__ import annotations

import enum
import os
from typing import Optional

import numpy as np
import torch

from . import lie, resolve_device
from .config import Settings, load_settings
from .engine.config import SlamConfig
from .engine.stereo_tracker import RgbdTracker, StereoTracker
from .engine.tracker import FrameRecord, MonoTracker, TrackState
from .engine.vio_tracker import VioTracker
from .io.serialization import load_map, save_map
from .io.trajectory import save_tum
from .io.writers import save_euroc, save_kitti
from .map.convert import desc_to_numpy
from .utils.verbose import Verbose

_LUMA = (0.299, 0.587, 0.114)


class Sensor(enum.Enum):
    MONOCULAR = "mono"
    STEREO = "stereo"
    RGBD = "rgbd"
    IMU_MONOCULAR = "mono-imu"
    IMU_STEREO = "stereo-imu"


def _luma(img: torch.Tensor, rgb: bool) -> torch.Tensor:
    """(H, W, 3) -> (H, W): the reference's ``img @ w`` with its bits. For
    float32 XLA:CPU computes ``fma(x2, w2, fma(x1, w1, x0 * w0))``; each
    fused multiply-add goes through float64 (the product is exact there)
    and is rounded once to float32."""
    w = torch.tensor(_LUMA, dtype=torch.float32).to(img.dtype)
    if not rgb:
        w = w.flip(0)                    # BGR input
    w = w.to(img.device)
    if not img.is_floating_point():
        return (img * w).sum(-1)
    acc = img[..., 0] * w[0]
    for c in (1, 2):
        acc = (img[..., c].double() * w[c].double()
               + acc.double()).to(img.dtype)
    return acc


class System:
    """One SLAM session over a configured sensor rig."""

    def __init__(self, settings_path: Optional[str] = None,
                 sensor: Sensor = Sensor.MONOCULAR,
                 settings: Optional[Settings] = None,
                 config: Optional[SlamConfig] = None,
                 verbosity: int = Verbose.NORMAL,
                 crash_dir: Optional[str] = None, device=None):
        self.device = dev = resolve_device(device)
        Verbose.set_level(verbosity)
        if crash_dir is not None:
            # Breakpad-minidump role (reference slam_euroc_si.cc:38-57)
            from .utils.crash import install_crash_handler, set_state_probe
            install_crash_handler(crash_dir)
            set_state_probe(self._crash_snapshot)
        self.sensor = sensor
        if settings is None and settings_path is not None:
            settings = load_settings(settings_path, sensor.value, device=dev)
        self.settings = settings
        cfg = config or (settings.slam if settings else SlamConfig())

        fisheye_rig = settings is not None and settings.cam2_params is not None
        if sensor == Sensor.MONOCULAR:
            self.tracker = MonoTracker(cfg, device=dev)
        elif sensor == Sensor.STEREO:
            if fisheye_rig:
                from .engine.stereo_tracker import FisheyeStereoTracker
                lap1, lap2 = settings.lapping or (None, None)
                self.tracker = FisheyeStereoTracker(
                    cfg, settings.cam2_params, settings.T_c1_c2, lap1, lap2,
                    device=dev)
            else:
                self.tracker = StereoTracker(
                    cfg, settings.baseline if settings else 0.11, device=dev)
        elif sensor == Sensor.RGBD:
            self.tracker = RgbdTracker(
                cfg, settings.baseline if settings else 0.08, device=dev)
        elif sensor == Sensor.IMU_MONOCULAR:
            if settings is None or settings.calib is None:
                raise ValueError("inertial sensor requires IMU calibration")
            self.tracker = VioTracker(cfg, settings.calib, device=dev)
        elif sensor == Sensor.IMU_STEREO:
            if settings is None or settings.calib is None:
                raise ValueError("inertial sensor requires IMU calibration")
            if fisheye_rig:
                from .engine.vio_tracker import FisheyeStereoVioTracker
                lap1, lap2 = settings.lapping or (None, None)
                self.tracker = FisheyeStereoVioTracker(
                    cfg, settings.cam2_params, settings.T_c1_c2,
                    settings.calib, lap1, lap2, device=dev)
            else:
                from .engine.vio_tracker import StereoVioTracker
                self.tracker = StereoVioTracker(cfg, settings.baseline,
                                                settings.calib, device=dev)
        else:
            raise ValueError(f"unknown sensor {sensor}")
        self._localization_only = False
        self._rect_maps_dev = None
        # auto-restore a previous session (reference system.cc:141-190:
        # LoadAtlasFromFile; missing file -> message + fresh atlas)
        if settings is not None and settings.load_atlas:
            if os.path.exists(settings.load_atlas):
                self.load_atlas(settings.load_atlas)
            else:
                Verbose.log(f"atlas file {settings.load_atlas!r} not found — "
                            "starting a new session", Verbose.NORMAL)
        Verbose.log(f"System ready: sensor={sensor.value}", Verbose.NORMAL)

    # -- per-frame entries (reference system.cc:259/374/459) ---------------

    def _tensor(self, img) -> torch.Tensor:
        """An image (tensor or array) on the session's device, its dtype
        kept."""
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device)

    def track_monocular(self, img, timestamp: float) -> FrameRecord:
        return self.tracker.process_image(self._preprocess(img), timestamp)

    def _preprocess(self, img) -> torch.Tensor:
        """Color->gray conversion + optional resize (reference
        System::Track* preprocessing: cvtColor in Tracking::GrabImage*,
        cv::resize in system.cc:279-285)."""
        img = self._tensor(img)
        if img.ndim == 3 and img.shape[-1] == 3:
            img = _luma(img, self.settings is None or self.settings.rgb)
        if self.settings is not None and self.settings.resize_to is not None:
            from .frontend.pyramid import resize_bilinear
            img = resize_bilinear(img, self.settings.resize_to)
        return img

    def track_monocular_features(self, feats, timestamp: float
                                 ) -> FrameRecord:
        return self.tracker.process_features(feats, timestamp)

    def track_monocular_imu(self, img_or_feats, timestamp, acc, gyro, t
                            ) -> FrameRecord:
        """Monocular frame + IMU batch (reference System::TrackMonocular
        with vImuMeas). Accepts a raw image or pre-extracted Features."""
        feats = img_or_feats
        if hasattr(img_or_feats, "ndim") and img_or_feats.ndim >= 2:
            from .frontend import extractor
            feats = self.tracker._undistort(extractor.extract_features(
                self.tracker._image(self._preprocess(img_or_feats)),
                self.tracker.cfg.orb))
        return self.tracker.process_frame_imu(feats, timestamp, acc, gyro, t)

    def track_stereo(self, imgL, imgR, timestamp: float) -> FrameRecord:
        imgL, imgR = self._rectify(self._preprocess(imgL),
                                   self._preprocess(imgR))
        return self.tracker.process_stereo_images(imgL, imgR, timestamp)

    def track_stereo_imu(self, imgL, imgR, timestamp: float,
                         acc, gyro, t) -> FrameRecord:
        """Stereo pair + IMU measurement batch (reference System::TrackStereo
        with vImuMeas, system.cc:259-326): rectify, extract both images,
        feed the inertial tracker."""
        from .frontend import extractor
        from .utils.timing import stage
        imgL, imgR = self._rectify(self._preprocess(imgL),
                                   self._preprocess(imgR))
        imgL, imgR = self.tracker._image(imgL), self.tracker._image(imgR)
        with stage("orb_extract"):
            fL = extractor.extract_features(imgL, self.tracker.cfg.orb)
            fR = extractor.extract_features(imgR, self.tracker.cfg.orb)
        return self.tracker.process_stereo_imu(fL, fR, timestamp,
                                               acc, gyro, t,
                                               images=(imgL, imgR))

    def _rectify(self, imgL, imgR):
        """Per-frame stereo rectification for unrectified pinhole rigs
        (reference System::TrackStereo cv::remap, system.cc:271-281)."""
        if self.settings is None or self.settings.rect_maps is None:
            return imgL, imgR
        if self._rect_maps_dev is None:
            self._rect_maps_dev = tuple(
                torch.from_numpy(np.asarray(m, np.float32)).to(self.device)
                for m in self.settings.rect_maps)
        from .frontend.rectify import remap_stereo_pair
        return remap_stereo_pair(imgL, imgR, *self._rect_maps_dev)

    def track_rgbd(self, img, depth, timestamp: float) -> FrameRecord:
        depth = self._tensor(depth)
        if self.settings is not None and self.settings.depth_map_factor != 1.0:
            # raw sensor units -> metres (reference DepthMapFactor,
            # tracking.cc GrabImageRGBD); a tensor divisor, so the
            # quotient is a true division (a scalar one becomes a product
            # with its reciprocal on the card)
            depth = depth.to(torch.float32)
            depth = depth / torch.full_like(
                depth, self.settings.depth_map_factor)
        return self.tracker.process_rgbd_images(self._preprocess(img), depth,
                                                timestamp)

    # -- modes (reference ActivateLocalizationMode, system.cc:287) ---------

    def activate_localization_mode(self) -> None:
        """Tracking-only: the map is frozen (no keyframes, no new points)."""
        if not self._localization_only:
            self._localization_only = True
            self._saved_need_kf = self.tracker._need_new_keyframe
            self.tracker._need_new_keyframe = lambda n: False
            Verbose.log("localization-only mode ON", Verbose.NORMAL)

    def deactivate_localization_mode(self) -> None:
        if self._localization_only:
            self._localization_only = False
            self.tracker._need_new_keyframe = self._saved_need_kf
            Verbose.log("localization-only mode OFF", Verbose.NORMAL)

    def reset(self) -> None:
        """Full reset (reference System::Reset)."""
        self.tracker.reset_map()

    # -- outputs (reference system.cc:558-1275) ----------------------------

    def _sync_background(self) -> None:
        """Sync point before exports/checkpoints: run any in-flight chunked
        GBA to completion so outputs see the corrected map (reference joins
        the GBA thread in Shutdown, system.cc:509-551)."""
        if hasattr(self.tracker, "_lba_drain"):
            self.tracker._lba_drain()
        lc = self.tracker.loop_closer
        if lc is not None:
            lc.gba_drain(self.tracker)

    def save_trajectory_tum(self, path: str) -> None:
        self._sync_background()
        save_tum(path, self.tracker.trajectory_tum())

    def save_trajectory_euroc(self, path: str) -> None:
        self._sync_background()
        save_euroc(path, self.tracker.trajectory_tum())

    def save_interactive_viewer(self, path: str, title: str = "") -> None:
        """Export the session as a self-contained interactive HTML viewer
        (reference: the live Pangolin Viewer, src/viewer.cc:156-188)."""
        self._sync_background()
        from .viz.viewer import export_interactive
        t = self.tracker
        edges = t.loop_closer.loop_edges if t.loop_closer else []
        export_interactive(
            t.map, path, trajectory=t.trajectory_tum(), loop_edges=edges,
            title=title or f"orb_slam_fusion_tpu — {len(t.trajectory)} "
            f"frames, {int(t.map.n_kf)} KFs")

    def save_trajectory_kitti(self, path: str) -> None:
        self._sync_background()
        poses = [lie.se3_inverse(Tcw)
                 for _, Tcw in self.tracker.resolved_poses()]
        save_kitti(path, poses)

    def _keyframe_rows(self) -> np.ndarray:
        """(valid keyframes, 8) rows [t, tx, ty, tz, qx, qy, qz, qw] of
        the keyframes' camera-to-world poses."""
        m = self.tracker.map
        rows = []
        for k in range(int(m.n_kf)):
            if not bool(m.kf_valid[k]):
                continue
            Twc = lie.se3_inverse(lie.SE3(m.kf_pose.R[k], m.kf_pose.t[k]))
            q = lie.quat_from_mat(Twc.R).cpu().numpy()
            t = Twc.t.cpu().numpy()
            rows.append([float(m.kf_timestamp[k]), t[0], t[1], t[2],
                         q[1], q[2], q[3], q[0]])
        return np.asarray(rows)

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        self._sync_background()
        save_tum(path, self._keyframe_rows())

    def save_keyframe_trajectory_euroc(self, path: str) -> None:
        """Reference System::SaveKeyFrameTrajectoryEuRoC (system.cc)."""
        self._sync_background()
        save_euroc(path, self._keyframe_rows())

    # -- state accessors (reference system.h:181-192) ----------------------

    def get_tracking_state(self):
        """Reference System::GetTrackingState (int-valued enum)."""
        return self.tracker.state

    def is_lost(self) -> bool:
        return self.tracker.state == TrackState.LOST

    def map_changed(self) -> bool:
        """True once per map revision (reference System::MapChanged — the
        Atlas change-index handshake)."""
        cur = int(self.tracker.map.n_kf) + int(self.tracker.map.n_mp)
        changed = cur != getattr(self, "_last_map_index", -1)
        self._last_map_index = cur
        return changed

    def get_tracked_map_points(self) -> np.ndarray:
        """Map-point rows observed by the current frame (reference
        GetTrackedMapPoints; -1 entries = unmatched features)."""
        obs = self.tracker._cur_obs
        return obs.cpu().numpy() if obs is not None else \
            np.empty(0, np.int32)

    def get_time_from_imu_init(self) -> float:
        # the reference reads ``imu_init_time``, which no tracker sets, so
        # this is 0.0 in both packages
        t = getattr(self.tracker, "imu_init_time", None)
        if t is None or not getattr(self.tracker, "imu_initialized", False):
            return 0.0
        last = self.tracker.trajectory[-1].timestamp \
            if self.tracker.trajectory else t
        return max(0.0, last - t)

    def get_image_scale(self) -> float:
        """Reference System::GetImageScale (resize factor vs raw input)."""
        return self.settings.image_scale if self.settings else 1.0

    def reset_active_map(self) -> None:
        """Archive + restart only the active map (reference
        System::ResetActiveMap -> Tracking::ResetActiveMap)."""
        self.tracker.reset_map()

    def change_dataset(self) -> None:
        """Mark a timestamp discontinuity between sequences (reference
        System::ChangeDataset): drop the motion model so the next frame
        re-anchors instead of extrapolating across the jump."""
        self.tracker.velocity = lie.se3_identity(device=self.device)
        self.tracker.frames_since_kf = 0

    # -- atlas persistence (reference SaveAtlas/LoadAtlas) -----------------

    def _vocab_words(self) -> Optional[np.ndarray]:
        """The vocabulary's words (flat codebook or tree centroids) as
        uint32, for the atlas MD5 guard (reference: system.cc:1391)."""
        lc = self.tracker.loop_closer
        if lc is None:
            return None
        vocab = lc.db.vocab
        return desc_to_numpy(vocab.words if hasattr(vocab, "words")
                             else vocab.node_desc)

    def save_atlas(self, path: str) -> None:
        """Full-session checkpoint (reference System::SaveAtlas,
        system.cc:1391-1527): the ACTIVE map, every ARCHIVED atlas map with
        its BoW rows, the per-keyframe inertial state incl. the raw IMU
        windows (so preintegrations re-linearize exactly on resume), and
        the persisted loop edges. The file is the JAX package's format."""
        from .io.serialization import map_to_arrays
        self._sync_background()
        t = self.tracker
        vocab = self._vocab_words()
        extras = {}
        if hasattr(t, "kf_uright"):
            extras["kf_uright"] = t.kf_uright
        # archived atlas maps + their BoW matrices
        extras["n_archived"] = np.int64(len(t.atlas.archived))
        for i, am in enumerate(t.atlas.archived):
            extras.update(map_to_arrays(am.map, prefix=f"arch{i}_"))
            extras[f"arch{i}_bow"] = am.bow
            extras[f"arch{i}_present"] = am.present
        # inertial per-keyframe state (velocities, biases, times, raw
        # measurement windows — reference: KF serialization carries
        # mpImuPreintegrated + velocity + biases, keyframe.h:146-188)
        if hasattr(t, "imu_initialized"):
            n = len(t.kf_vel)

            def host(x):
                return x.detach().cpu().numpy()
            extras["imu_meta"] = np.array(
                [float(t.imu_initialized), float(t._imu_stage),
                 float(t._imu_init_time)], np.float64)
            extras["imu_cur"] = np.concatenate([
                host(t.bias.gyro).astype(np.float64),
                host(t.bias.acc).astype(np.float64),
                host(t.cur_vel).astype(np.float64)])
            extras["kf_vel"] = (np.stack(t.kf_vel) if n
                                else np.zeros((0, 3), np.float32))
            extras["kf_bias"] = (np.stack(
                [np.concatenate([host(b.gyro), host(b.acc)])
                 for b in t.kf_bias]) if n else np.zeros((0, 6), np.float32))
            extras["kf_time"] = np.asarray(t.kf_time, np.float64)
            accs, gyrs, dts, lens = [], [], [], []
            for raw in t.kf_raw:
                if raw is None:
                    lens.append(0)
                else:
                    a, g, d = raw
                    lens.append(len(d))
                    accs.append(np.asarray(a, np.float64))
                    gyrs.append(np.asarray(g, np.float64))
                    dts.append(np.asarray(d, np.float64))
            extras["imu_raw_acc"] = (np.concatenate(accs) if accs
                                     else np.zeros((0, 3)))
            extras["imu_raw_gyro"] = (np.concatenate(gyrs) if gyrs
                                      else np.zeros((0, 3)))
            extras["imu_raw_dt"] = (np.concatenate(dts) if dts
                                    else np.zeros(0))
            extras["imu_raw_len"] = np.asarray(lens, np.int64)
        # persisted loop edges (relative Sim3 measurements)
        lc = t.loop_closer
        if lc is not None and lc.loop_edges:
            extras["loop_i"] = np.asarray(
                [e[0] for e in lc.loop_edges], np.int64)
            extras["loop_j"] = np.asarray(
                [e[1] for e in lc.loop_edges], np.int64)
            for key, field in (("loop_s", "s"), ("loop_R", "R"),
                               ("loop_t", "t")):
                extras[key] = np.stack(
                    [getattr(e[2], field).detach().cpu().numpy()
                     for e in lc.loop_edges])
        save_map(path, t.map, vocab, **extras)
        Verbose.log(f"atlas saved to {path} "
                    f"({len(t.atlas.archived)} archived maps)",
                    Verbose.NORMAL)

    def load_atlas(self, path: str) -> None:
        from .io.serialization import map_from_arrays
        from .map.atlas import ArchivedMap
        dev = self.device
        vocab = self._vocab_words()
        m, extras = load_map(path, vocab, device=dev)
        t = self.tracker

        def tensor(a, dtype=None):
            a = torch.from_numpy(np.array(a))
            return a.to(dev) if dtype is None else a.to(dev, dtype)
        # trajectory so far was relative to the outgoing map's keyframes
        t._freeze_trajectory()
        t.map = m
        if "kf_uright" in extras and hasattr(t, "kf_uright"):
            t.kf_uright = tensor(extras["kf_uright"], torch.float32)
        # archived atlas maps
        t.atlas.archived = []
        for i in range(int(extras.get("n_archived", 0))):
            pre = f"arch{i}_"
            am = map_from_arrays(
                lambda name: (np.asarray(extras[name])
                              if name in extras else None), prefix=pre,
                device=dev)
            t.atlas.archived.append(ArchivedMap(
                am, tensor(extras[pre + "bow"], torch.float32),
                tensor(extras[pre + "present"])))
        # inertial state
        if hasattr(t, "imu_initialized") and "imu_meta" in extras:
            from .imu.preintegration import ImuBias, preintegrate_host
            meta = np.asarray(extras["imu_meta"])
            t.imu_initialized = bool(meta[0] > 0.5)
            t._imu_stage = int(meta[1])
            t._imu_init_time = float(meta[2])
            cur = np.asarray(extras["imu_cur"])
            f32 = torch.float32
            t.bias = ImuBias(tensor(cur[0:3], f32), tensor(cur[3:6], f32))
            t.cur_vel = tensor(cur[6:9], f32)
            kf_vel = np.asarray(extras["kf_vel"])
            kf_bias = np.asarray(extras["kf_bias"])
            t.kf_vel = [kf_vel[k] for k in range(len(kf_vel))]
            t.kf_bias = [ImuBias(tensor(kf_bias[k, :3], f32),
                                 tensor(kf_bias[k, 3:], f32))
                         for k in range(len(kf_bias))]
            t.kf_time = [float(x) for x in np.asarray(extras["kf_time"])]
            lens = np.asarray(extras["imu_raw_len"])
            acc = np.asarray(extras["imu_raw_acc"])
            gyr = np.asarray(extras["imu_raw_gyro"])
            dts = np.asarray(extras["imu_raw_dt"])
            t.kf_raw, t.kf_pre = [], []
            off = 0
            for k, ln in enumerate(lens):
                if ln == 0:
                    t.kf_raw.append(None)
                    t.kf_pre.append(None)
                else:
                    raw = (acc[off:off + ln], gyr[off:off + ln],
                           dts[off:off + ln])
                    off += ln
                    t.kf_raw.append(raw)
                    t.kf_pre.append(preintegrate_host(
                        *raw, t.kf_bias[k], t.calib))
            t._prior = None
        # rebuild the BoW database for relocalization/loops + loop edges
        if t.loop_closer is not None:
            for k in range(int(m.n_kf)):
                if bool(m.kf_valid[k]):
                    t.loop_closer.add_keyframe(
                        k, m.kf_desc[k], m.kf_feat_valid[k])
            if "loop_i" in extras:
                li = np.asarray(extras["loop_i"])
                lj = np.asarray(extras["loop_j"])
                ls = np.asarray(extras["loop_s"])
                lR = np.asarray(extras["loop_R"])
                lt = np.asarray(extras["loop_t"])
                t.loop_closer.loop_edges = [
                    (int(li[e]), int(lj[e]),
                     lie.Sim3(tensor(ls[e]), tensor(lR[e]), tensor(lt[e])))
                    for e in range(len(li))]
        t.state = TrackState.LOST  # relocalize into the map
        t.lost_since = t.frame_id
        Verbose.log(f"atlas loaded from {path} "
                    f"({int(m.n_kf)} KFs, {int(m.n_mp)} points, "
                    f"{len(t.atlas.archived)} archived maps)",
                    Verbose.NORMAL)

    # -- instrumentation (reference REGISTER_TIMES, tracking.h:330-336) ----

    def enable_timing(self) -> None:
        """Per-stage wall-clock accounting (reference REGISTER_TIMES)."""
        from .utils.timing import STAGES
        STAGES.enable()

    def save_timing_stats(self, path: str) -> None:
        """Dump per-stage timing + LBA counters (reference f_track_stats /
        f_track_times ofstreams)."""
        from .utils.timing import STAGES
        with open(path, "w") as f:
            f.write(STAGES.report() + "\n")

    def save_debug_data(self, path: str) -> None:
        """Session state dump (reference System::SaveDebugData,
        system.cc:1277 — IMU-init debugging aid)."""
        t = self.tracker
        with open(path, "w") as f:
            f.write(self._crash_snapshot() + "\n")
            f.write(f"trajectory_frames={len(t.trajectory)}\n")
            if hasattr(t, "imu_initialized"):
                f.write(f"imu_initialized={t.imu_initialized}\n")
                f.write(f"bias_gyro={t.bias.gyro.cpu().numpy().tolist()}\n")
                f.write(f"bias_acc={t.bias.acc.cpu().numpy().tolist()}\n")
            from .utils.timing import STAGES
            f.write(STAGES.report() + "\n")

    def _crash_snapshot(self) -> str:
        t = self.tracker
        return (f"sensor={self.sensor.value} state={t.state.name} "
                f"frame={t.frame_id} kf={int(t.map.n_kf)} "
                f"mp={int(t.map.n_mp)}")

    def shutdown(self) -> None:
        """Reference System::Shutdown — no threads to join here; saves the
        session when the config asks for it (system.cc:543-550)."""
        if self.settings is not None and self.settings.save_atlas:
            self.save_atlas(self.settings.save_atlas)
        Verbose.log("shutdown", Verbose.NORMAL)
