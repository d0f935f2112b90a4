"""Visual-inertial sessions: monocular-, stereo- and fisheye-stereo-inertial.

Counterpart of ``orb_slam_fusion_tpu/engine/vio_tracker.py``. The mixin
adds the reference's inertial machinery to the visual trackers:

* per-frame IMU preintegration from the last frame and from the last
  keyframe (the float64 host integrator);
* IMU pose prediction for matching once initialized;
* the per-frame pose-inertial solve with a marginalized prior;
* the staged IMU initialization (first init, VIBA1 at t > 5 s, VIBA2 at
  t > 15 s): gravity direction, scale (monocular), biases and velocities
  from ``inertial_init``, the scaled-rotation gauge transform of the whole
  map, re-integration at the new bias and a full visual-inertial BA;
* after initialization, the windowed visual-inertial BA as local BA.

The per-keyframe inertial records are host lists, as in the reference,
and so are its host reads of the map's keyframe count, the init's scale
and the solved velocities. The atlas archive keeps them
(``_inertial_archive_snapshot``); after a merge (``_on_maps_merged``,
the reference's MergeLocal2) they are re-homed into the welded index
space, the active map's velocities move by the weld Sim3, and an
initialized session re-aligns gravity over the joint history and re-runs
the full visual-inertial BA.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import lie
from ..frontend.stereo import fisheye_stereo_match, stereo_match, \
    subpixel_refine
from ..imu.factors import information_from_cov
from ..imu.preintegration import (ImuBias, ImuCalib, Preintegrated,
                                  gravity_vec, preintegrate_host,
                                  stack_preintegrated, zero_bias)
from ..map import map_state as ms
from ..solver import ba
from ..solver.pose_inertial_prior import (make_initial_prior,
                                          pose_inertial_marginalized)
from ..solver.vi_ba import (InertialFactorBatch, VIState, body_state,
                            inertial_init, visual_inertial_ba)
from ..utils.timing import stage
from .config import SlamConfig
from .stereo_tracker import FisheyeStereoTracker, StereoTracker
from .tracker import FrameRecord, MonoTracker, TrackState


def _concat_raw(a: Optional[tuple], b: Optional[tuple]) -> Optional[tuple]:
    """Concatenate two raw (acc, gyro, dt) measurement windows."""
    if a is None:
        return b
    if b is None:
        return a
    return tuple(np.concatenate([x, y]) for x, y in zip(a, b))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class InertialMixin:
    """IMU machinery shared by the inertial trackers; mix into a visual
    tracker class. ``_imu_optimize_scale`` says whether the init estimates
    a scale (monocular) or trusts the visual metric scale (stereo)."""

    _imu_optimize_scale = True

    def _tri_covisible(self) -> int:
        """Inertial sessions triangulate against the temporal chain only
        (the reference's choice: long-baseline covisible pairs destabilize
        the staged initialization)."""
        return 0

    def _init_inertial(self, calib: ImuCalib):
        dev = self.device
        self.calib = ImuCalib(*(c.to(dev) for c in calib))
        self.imu_initialized = False
        self.gravity_w = gravity_vec(dev)
        self.bias = zero_bias(dev)
        self.cur_vel = torch.zeros(3, dtype=torch.float32, device=dev)
        # per-keyframe inertial records (host lists, indexed by kf row)
        self.kf_vel: List[np.ndarray] = []
        self.kf_bias: List[ImuBias] = []
        self.kf_pre: List[Optional[Preintegrated]] = []  # from previous KF
        self.kf_time: List[float] = []
        # raw (acc, gyro, dt) windows per keyframe: re-integration at a
        # moved bias, and merging when the previous keyframe is culled
        self.kf_raw: List[Optional[tuple]] = []
        self._buf_kf = ([], [], [])   # acc, gyro, dt since the last KF
        self._last_frame_time: Optional[float] = None
        self._pre_frame: Optional[Preintegrated] = None
        self._prev_pose_imu = self.cur_pose
        self._prev_vel_imu = self.cur_vel
        # marginalized 15-dim prior carried frame to frame
        self._prior = None
        # staged initialization: 1 = first init, 2 = VIBA1 (t > 5 s),
        # 3 = VIBA2 (t > 15 s)
        self._imu_stage = 0
        self._imu_init_time = 0.0
        self.init_min_time = 2.0      # seconds of keyframes before init
        self.init_min_kfs = 8

    # -- public API --------------------------------------------------------

    def process_frame_imu(self, feats, timestamp: float, acc: np.ndarray,
                          gyro: np.ndarray, meas_t: np.ndarray
                          ) -> FrameRecord:
        """Features plus the IMU samples in (last frame time, timestamp]."""
        pre_frame = None
        if self._last_frame_time is not None and len(meas_t) > 0:
            dts = np.diff(np.concatenate(
                [[self._last_frame_time], np.asarray(meas_t)]))
            dts = np.maximum(dts, 0.0)
            # tail to the frame timestamp
            tail = max(0.0, timestamp - float(meas_t[-1]))
            acc_w = np.concatenate([acc, acc[-1:]])
            gyro_w = np.concatenate([gyro, gyro[-1:]])
            dts_w = np.concatenate([dts, [tail]])
            with stage("imu_preintegrate"):
                pre_frame = preintegrate_host(acc_w, gyro_w, dts_w,
                                              self.bias, self.calib)
            a, g, d = self._buf_kf
            a.extend(acc_w.tolist())
            g.extend(gyro_w.tolist())
            d.extend(dts_w.tolist())

        # the previous frame's optimized state: the fixed side of the
        # per-frame pose-inertial factor
        self._pre_frame = pre_frame
        self._prev_pose_imu = self.cur_pose
        self._prev_vel_imu = self.cur_vel

        # IMU pose prediction replaces the constant-velocity model
        if self.imu_initialized and pre_frame is not None \
                and self.state == TrackState.OK:
            self._predict_with_imu(pre_frame)

        rec = self._process_visual(feats, timestamp)
        self._last_frame_time = timestamp
        return rec

    def _process_visual(self, feats, timestamp) -> FrameRecord:
        """Visual routing hook (the stereo session bootstraps from
        disparity)."""
        return self.process_features(feats, timestamp)

    def _post_track_refine(self, feats, upd) -> None:
        """Per-frame pose-inertial re-solve with the marginalized prior,
        then the previous state marginalized into the next prior."""
        if not self.imu_initialized or self._pre_frame is None:
            return
        if self._prior is None:
            self._prior = make_initial_prior(
                self._prev_pose_imu, self._prev_vel_imu, self.bias)
        m = self.map
        obs = upd.obs
        mp = torch.clamp(obs, 0, m.max_mp - 1).long()
        valid = (obs >= 0) & feats.valid
        inv_s2 = self.inv_s2[torch.clamp(
            feats.octave, 0, self.cfg.orb.num_levels - 1).long()]
        with stage("pose_inertial"):
            info = information_from_cov(self._pre_frame)
            pose, vel, bias, prior, _, _ = pose_inertial_marginalized(
                self._prior, self.cur_pose, self.cur_vel, self._pre_frame,
                info, self.calib, m.mp_pos[mp], feats.uv, inv_s2, valid,
                self.cam_params, cam_model=self.cfg.cam_model)
        self.cur_pose = pose
        self.cur_vel = vel
        self.bias = ImuBias(bias.gyro, bias.acc)
        self._prior = prior
        self.velocity = lie.se3_compose(pose, lie.se3_inverse(self.last_pose))

    def _reset_prior(self) -> None:
        """Restart the marginalization chain from the current (keyframe-
        refreshed or map-corrected) state."""
        if not self.imu_initialized:
            self._prior = None
            return
        self._prior = make_initial_prior(self.cur_pose, self.cur_vel,
                                         self.bias)

    # -- prediction --------------------------------------------------------

    def _predict_with_imu(self, pre: Preintegrated):
        """Propagate (pose, vel) with the preintegrated frame delta and
        encode it as the motion model the tracker predicts with."""
        R_wb, p_wb = body_state(self.cur_pose, self.calib)
        dt = float(pre.dT)
        g = self.gravity_w
        R_wb2 = R_wb @ pre.dR
        v2 = self.cur_vel + g * dt + R_wb @ pre.dV
        p2 = p_wb + self.cur_vel * dt + 0.5 * g * dt * dt + R_wb @ pre.dP
        # back to the camera pose: T_cw = T_cb o T_bw
        R_bw = R_wb2.T
        t_bw = -R_bw @ p2
        Tcb_R = self.calib.Tbc_R.T
        Tcb_t = -Tcb_R @ self.calib.Tbc_t
        pred = lie.SE3(Tcb_R @ R_bw, Tcb_R @ t_bw + Tcb_t)
        self.velocity = lie.se3_compose(pred, lie.se3_inverse(self.cur_pose))
        self.cur_vel = v2

    # -- keyframe hooks ----------------------------------------------------

    def _pad_inertial_records(self, timestamp) -> None:
        """Bootstrap keyframes predate any usable preintegration window:
        they carry no inertial factor."""
        n_kf = int(self.map.n_kf)
        while len(self.kf_pre) < n_kf:
            self.kf_pre.append(None)
            self.kf_raw.append(None)
            self.kf_vel.append(np.zeros(3, np.float32))
            self.kf_bias.append(self.bias)
            self.kf_time.append(timestamp)
        self._buf_kf = ([], [], [])

    def _create_initial_map(self, feats, timestamp, idx, res):
        super()._create_initial_map(feats, timestamp, idx, res)
        self._pad_inertial_records(timestamp)

    def _stereo_initialize(self, feats, timestamp):
        rec = super()._stereo_initialize(feats, timestamp)
        self._pad_inertial_records(timestamp)
        return rec

    def _insert_keyframe(self, feats, timestamp, obs):
        prev_n = int(self.map.n_kf)
        # record the inertial state BEFORE the base insert, whose local BA
        # (after IMU init) reads these tables for the new keyframe row
        a, g, d = self._buf_kf
        pre, raw = None, None
        if len(d) > 0 and prev_n > 0:
            raw = (np.asarray(a, np.float64), np.asarray(g, np.float64),
                   np.asarray(d, np.float64))
            pre = preintegrate_host(*raw, self.bias, self.calib)
        self._buf_kf = ([], [], [])
        self.kf_pre.append(pre)
        self.kf_raw.append(raw)
        self.kf_vel.append(_host(self.cur_vel))
        self.kf_bias.append(self.bias)
        self.kf_time.append(timestamp)

        super()._insert_keyframe(feats, timestamp, obs)
        if int(self.map.n_kf) == prev_n:   # insert failed: roll back
            for lst in (self.kf_pre, self.kf_raw, self.kf_vel, self.kf_bias,
                        self.kf_time):
                lst.pop()
            return

        if not self.imu_initialized:
            self._maybe_initialize_imu()
        else:
            self._staged_inertial_refine()
        # the windowed VI-BA / IMU init just re-anchored the state
        self._reset_prior()

    def reset_map(self):
        super().reset_map()
        self.imu_initialized = False
        self.bias = zero_bias(self.device)
        self.cur_vel = torch.zeros(3, dtype=torch.float32, device=self.device)
        self.kf_vel, self.kf_bias, self.kf_pre, self.kf_time = [], [], [], []
        self.kf_raw = []
        self._buf_kf = ([], [], [])
        self._pre_frame = None
        self._prior = None
        self._imu_stage = 0
        self._imu_init_time = 0.0

    def _inertial_archive_snapshot(self):
        return {"kf_vel": list(self.kf_vel), "kf_bias": list(self.kf_bias),
                "kf_pre": list(self.kf_pre), "kf_time": list(self.kf_time),
                "kf_raw": list(self.kf_raw)}

    def _on_maps_merged(self, arch, kf_off: int, S_new_to_old):
        """Inertial merge (reference MergeLocal2 + MergeInertialBA):
        re-home the per-keyframe tables into the welded index space, move
        the active map's velocities by the weld (v' = s R v; biases and
        body-frame preintegrations do not change), then re-align gravity
        and re-solve the full inertial history over the merged map."""
        super()._on_maps_merged(arch, kf_off, S_new_to_old)
        s = float(S_new_to_old.s)
        R = _host(S_new_to_old.R)
        new_vel = [s * (R @ np.asarray(v)) for v in self.kf_vel]
        ai = arch.inertial
        if ai is None:
            old_ts = _host(arch.map.kf_timestamp[:kf_off])
            old = {"kf_vel": [np.zeros(3, np.float32)] * kf_off,
                   "kf_bias": [zero_bias(self.device)] * kf_off,
                   "kf_pre": [None] * kf_off,
                   "kf_time": [float(t) for t in old_ts],
                   "kf_raw": [None] * kf_off}
        else:
            old = ai
        self.kf_vel = list(old["kf_vel"]) + new_vel
        self.kf_bias = list(old["kf_bias"]) + list(self.kf_bias)
        self.kf_pre = list(old["kf_pre"]) + list(self.kf_pre)
        self.kf_time = list(old["kf_time"]) + list(self.kf_time)
        self.kf_raw = list(old["kf_raw"]) + list(self.kf_raw)
        self.cur_vel = torch.from_numpy(
            np.array(self.kf_vel[-1], np.float32)).to(self.device)
        # the merged world is the archived map's frame: gravity alignment
        # is re-established over the joint history
        if self.imu_initialized:
            if self._inertial_estimate_apply(refine=False):
                self._full_vi_ba()
            self._reset_prior()

    def _can_cull(self, k: int) -> bool:
        """Inertial culling gate: the merged preintegration window after
        the cull must stay under 3 s."""
        if k <= 0 or k + 1 >= len(self.kf_time):
            return False
        return (self.kf_time[k + 1] - self.kf_time[k - 1]) < 3.0

    def _on_kf_remap(self, old_to_new, order):
        """Keyframe compaction: permute the inertial tables, merging the
        raw windows of dropped keyframes into the next kept one."""
        super()._on_kf_remap(old_to_new, order)
        vel, bias, pre, time_, raw_l = [], [], [], [], []
        pending = None   # concatenated raw windows of dropped keyframes
        for k in range(len(self.kf_vel)):
            if old_to_new[k] >= 0:
                raw = self.kf_raw[k]
                p = self.kf_pre[k]
                if pending is not None:
                    raw = _concat_raw(pending, raw)
                    p = (preintegrate_host(
                        *raw, p.bias0 if p is not None else self.bias,
                        self.calib) if raw is not None else p)
                    pending = None
                vel.append(self.kf_vel[k])
                bias.append(self.kf_bias[k])
                pre.append(p)
                raw_l.append(raw)
                time_.append(self.kf_time[k])
            else:
                pending = _concat_raw(pending, self.kf_raw[k])
        self.kf_vel, self.kf_bias, self.kf_pre = vel, bias, pre
        self.kf_raw, self.kf_time = raw_l, time_

    # -- IMU initialization ------------------------------------------------

    def _inertial_factor_batch(self, lo: int, hi: int,
                               pad_to: Optional[int] = None
                               ) -> Optional[InertialFactorBatch]:
        """The stored preintegrations of keyframe rows [lo, hi) as a
        batch; ``pad_to`` pads it to a fixed length with invalid copies of
        the first factor."""
        pres, iis, jjs = [], [], []
        for k in range(max(lo + 1, 1), hi):
            if self.kf_pre[k] is not None:
                pres.append(self.kf_pre[k])
                iis.append(k - 1 - lo)
                jjs.append(k - lo)
        if not pres:
            return None
        n_real = len(pres)
        if pad_to is not None:
            if n_real > pad_to:
                pres, iis, jjs = pres[-pad_to:], iis[-pad_to:], jjs[-pad_to:]
                n_real = pad_to
            while len(pres) < pad_to:
                pres.append(pres[0])
                iis.append(iis[0])
                jjs.append(jjs[0])
        pre_b = stack_preintegrated(pres)
        dev = self.device
        return InertialFactorBatch(
            i=torch.tensor(iis, dtype=torch.int32, device=dev),
            j=torch.tensor(jjs, dtype=torch.int32, device=dev),
            pre=pre_b, info=information_from_cov(pre_b),
            valid=torch.arange(len(pres), device=dev) < n_real)

    def _maybe_initialize_imu(self):
        n_kf = int(self.map.n_kf)
        if n_kf < self.init_min_kfs:
            return
        if self.kf_time[-1] - self.kf_time[0] < self.init_min_time:
            return
        if self._inertial_estimate_apply(refine=False):
            self.imu_initialized = True
            self._imu_stage = 1
            self._imu_init_time = self.kf_time[-1]
            # the reference's InitializeIMU ends with a full inertial BA
            self._full_vi_ba()

    def _inertial_estimate_apply(self, refine: bool, prior_g: float = 1e2,
                                 prior_a: Optional[float] = None) -> bool:
        """Estimate (scale,) gravity, biases and velocities over all
        keyframes and apply them to the map. ``refine`` guards the re-runs
        (VIBA1/VIBA2): the correction must be near identity. ``prior_a``
        None is the first-init weight: 1e10 when the scale is estimated,
        1e5 when it is visual-metric."""
        if prior_a is None:
            prior_a = 1e10 if self._imu_optimize_scale else 1e5
        # the solve reads every keyframe pose and then gauge-transforms the
        # whole map: land a background local BA in flight first
        self._lba_drain()
        # ...and drop a GBA snapshot: its adoption cannot represent a
        # global gauge change
        if self.loop_closer is not None:
            self.loop_closer.pending_gba = None
        n_kf = int(self.map.n_kf)
        ifac = self._inertial_factor_batch(0, n_kf)
        if ifac is None or ifac.i.shape[0] < self.init_min_kfs - 2:
            return False

        poses = lie.SE3(self.map.kf_pose.R[:n_kf], self.map.kf_pose.t[:n_kf])
        with stage("inertial_init"):
            s, R_wg, bias, vel, _ = inertial_init(
                poses, ifac, self.calib,
                optimize_scale=self._imu_optimize_scale, prior_g=prior_g,
                prior_a=prior_a)
        s_f = float(s) if self._imu_optimize_scale else 1.0
        if not np.isfinite(s_f):
            return False
        if refine:
            # the reference's ScaleRefinement sanity: a small correction
            ang = float(torch.linalg.norm(lie.so3_log(R_wg)))
            if not (0.5 < s_f < 2.0) or ang > 0.35:
                return False
        elif s_f < 1e-3 or s_f > 1e3:
            return False

        self._apply_scaled_rotation(s_f, R_wg)
        self.bias = ImuBias(bias.gyro, bias.acc)
        # the init's velocities are already metric but in the old world
        # orientation: rotate only
        vel_new = _host(vel @ R_wg)
        self.kf_vel = [v for v in vel_new]
        self.kf_bias = [self.bias] * n_kf
        self.cur_vel = torch.from_numpy(self.kf_vel[-1].copy()).to(
            self.device)
        # re-integrate the stored windows at the estimated bias (exact,
        # from the raw buffers)
        self._reintegrate_all(self.bias)
        return True

    def _staged_inertial_refine(self):
        """VIBA1 at t > 5 s and VIBA2 at t > 15 s after the first keyframe:
        re-estimate gravity and bias (and scale, monocular) over the whole
        history, re-linearize the preintegrations, full VI-BA."""
        if not self.imu_initialized:
            return
        elapsed = self.kf_time[-1] - self.kf_time[0]
        if self._imu_stage == 1 and elapsed > 5.0:
            next_stage = 2
            prior_g, prior_a = 1.0, 1e5      # VIBA1
        elif self._imu_stage == 2 and elapsed > 15.0:
            next_stage = 3
            prior_g, prior_a = 1e-3, 1e-3    # VIBA2 (epsilon-regularized)
        else:
            return
        if self._inertial_estimate_apply(refine=True, prior_g=prior_g,
                                         prior_a=prior_a):
            self._full_vi_ba()
        # advance even on a rejected refine, as the reference does
        self._imu_stage = next_stage
        self._reset_prior()

    def _full_vi_ba(self):
        """Full-history visual-inertial BA (reference FullInertialBA),
        padded to a multiple of 16 keyframes."""
        n_kf = int(self.map.n_kf)
        if n_kf < 3:
            return
        W = -(-n_kf // 16) * 16
        self._vi_ba_over(np.arange(n_kf, dtype=np.int32), W, n_fixed=1,
                         iters=12)

    def _reintegrate_all(self, bias: ImuBias) -> None:
        for k in range(len(self.kf_pre)):
            if self.kf_raw[k] is not None:
                self.kf_pre[k] = preintegrate_host(*self.kf_raw[k], bias,
                                                   self.calib)

    def _apply_scaled_rotation(self, s: float, R_wg) -> None:
        """Gauge transform of the whole map, x' = s R_gw x (reference
        Map::ApplyScaledRotation): R_cw' = R_cw R_wg, t_cw' = s t_cw; the
        normals (world vectors) rotate with it."""
        m = self.map
        R_wg = R_wg.to(torch.float32)
        R_gw = R_wg.T
        valid = m.mp_valid[:, None]
        self.map = m._replace(
            kf_pose=lie.SE3(m.kf_pose.R @ R_wg, s * m.kf_pose.t),
            mp_pos=torch.where(valid, s * (m.mp_pos @ R_gw.T), m.mp_pos),
            mp_normal=torch.where(valid, m.mp_normal @ R_gw.T, m.mp_normal),
            mp_min_dist=m.mp_min_dist * s,
            mp_max_dist=torch.where(m.mp_max_dist < 1e8, m.mp_max_dist * s,
                                    m.mp_max_dist))
        k = self.last_kf_id
        self.cur_pose = lie.SE3(self.map.kf_pose.R[k], self.map.kf_pose.t[k])
        self.velocity = lie.se3_identity(device=self.device)
        self._reset_prior()

    # -- local mapping -----------------------------------------------------

    def _local_ba(self):
        if not self.imu_initialized:
            super()._local_ba()
            return
        cfg = self.cfg
        n_kf = int(self.map.n_kf)
        W = cfg.ba_window + cfg.ba_fixed_ring
        ids = np.arange(max(0, n_kf - W), n_kf, dtype=np.int32)
        n_fixed = max(len(ids) - cfg.ba_window, min(2, len(ids) - 1))
        self._vi_ba_over(ids, W, n_fixed=n_fixed,
                         iters=cfg.ba_iters_first + cfg.ba_iters_second)

    def _vi_ba_over(self, ids: np.ndarray, Wpad: int, n_fixed: int,
                    iters: int):
        """Windowed or full visual-inertial BA over keyframe rows ``ids``,
        padded to ``Wpad`` rows (reference LocalInertialBA /
        FullInertialBA)."""
        # a background visual LBA in flight solved the same rows: land it
        # first so its later write-back cannot clobber this solve
        self._lba_drain()
        # a pending GBA snapshot would scatter pre-VI-BA values: drop it
        if self.loop_closer is not None:
            self.loop_closer.pending_gba = None
        cfg = self.cfg
        dev = self.device
        n_kf = int(self.map.n_kf)
        start = int(ids[0])
        n_in = len(ids)
        window = np.full(Wpad, -1, np.int32)
        window[:n_in] = ids
        win = torch.from_numpy(window).to(dev)
        wclip = torch.from_numpy(np.clip(window, 0, None)).long().to(dev)

        kf_idx, mp_idx, uv, octv, valid = ms.observation_triples(self.map,
                                                                 win)
        inv_s2 = self.inv_s2[torch.clamp(
            octv, 0, cfg.orb.num_levels - 1).long()]
        poses = lie.SE3(self.map.kf_pose.R[wclip], self.map.kf_pose.t[wclip])
        fixed_pose = np.zeros(Wpad, bool)
        fixed_pose[:n_fixed] = True
        fixed_pose |= window < 0
        fixed = torch.from_numpy(fixed_pose).to(dev)

        stereo_kwargs = {}
        if hasattr(self, "kf_uright"):
            ur = self.kf_uright[wclip].reshape(-1)
            stereo_kwargs = dict(u_right=ur, stereo_mask=valid & (ur > 0),
                                 bf=self.bf)
        prob = ba.make_problem(
            poses, self.map.mp_pos, kf_idx, mp_idx, uv, inv_s2, valid, fixed,
            self.cam_params, fixed_point=~self.map.mp_valid, max_obs=Wpad,
            **stereo_kwargs)

        ifac = self._inertial_factor_batch(start, n_kf, pad_to=Wpad - 1)
        if ifac is None:
            super()._local_ba()
            return

        def table(rows):
            return torch.from_numpy(np.stack(
                [rows(k) if 0 <= k < n_kf else np.zeros(3, np.float32)
                 for k in window]).astype(np.float32)).to(dev)

        bias_host = {k: _host(torch.stack([self.kf_bias[k].gyro,
                                           self.kf_bias[k].acc]))
                     for k in ids}
        state = VIState(poses=poses,
                        vel=table(lambda k: self.kf_vel[k]),
                        bg=table(lambda k: bias_host[k][0]),
                        ba=table(lambda k: bias_host[k][1]))
        with stage("vi_ba"):
            new_state, new_points, _ = visual_inertial_ba(
                state, prob, ifac, self.calib, fixed_pose=fixed,
                fixed_inertial=fixed, cam_model=cfg.cam_model, iters=iters)

        ids_t = torch.from_numpy(ids).long().to(dev)
        m = self.map
        kf_R = m.kf_pose.R.clone()
        kf_t = m.kf_pose.t.clone()
        kf_R[ids_t] = new_state.poses.R[:n_in]
        kf_t[ids_t] = new_state.poses.t[:n_in]
        self.map = m._replace(
            kf_pose=lie.SE3(kf_R, kf_t),
            mp_pos=torch.where(m.mp_valid[:, None], new_points, m.mp_pos))
        vel_host = _host(new_state.vel)
        for slot, k in enumerate(ids):
            self.kf_vel[k] = vel_host[slot]
            self.kf_bias[k] = ImuBias(new_state.bg[slot], new_state.ba[slot])
        self.bias = self.kf_bias[n_kf - 1]
        self.cur_vel = torch.from_numpy(self.kf_vel[n_kf - 1].copy()).to(dev)
        if self.last_kf_id >= 0:
            k = self.last_kf_id
            self.cur_pose = lie.SE3(self.map.kf_pose.R[k],
                                    self.map.kf_pose.t[k])


class VioTracker(InertialMixin, MonoTracker):
    """Monocular-inertial session (reference: IMU_MONOCULAR)."""

    _imu_optimize_scale = True

    def __init__(self, config: SlamConfig, calib: ImuCalib, device=None):
        MonoTracker.__init__(self, config, device)
        self._init_inertial(calib)


class StereoVioTracker(InertialMixin, StereoTracker):
    """Stereo-inertial session (reference: IMU_STEREO, the slam_euroc_si
    headline configuration). The visual scale is metric, so the IMU init
    estimates gravity direction, biases and velocities only."""

    _imu_optimize_scale = False

    def __init__(self, config: SlamConfig, baseline: float,
                 calib: ImuCalib, device=None):
        StereoTracker.__init__(self, config, baseline, device)
        self._init_inertial(calib)

    def process_stereo_imu(self, featsL, featsR, timestamp, acc, gyro,
                           meas_t, images=None) -> FrameRecord:
        """A stereo pair of feature sets plus its IMU batch (reference
        System::TrackStereo with IMU measurements); ``images`` (the
        rectified pair) adds the subpixel disparity refinement."""
        u_right, has_stereo = stereo_match(featsL, featsR)
        if images is not None:
            u_right, has_stereo = subpixel_refine(
                images[0], images[1], featsL.uv, u_right, has_stereo)
        self._cur_uright = u_right
        self._cur_has_stereo = has_stereo
        return self.process_frame_imu(featsL, timestamp, acc, gyro, meas_t)

    def _process_visual(self, feats, timestamp) -> FrameRecord:
        if self.state in (TrackState.NO_IMAGES, TrackState.NOT_INITIALIZED):
            with stage("initialize"):
                rec = self._stereo_initialize(feats, timestamp)
            self.frame_id += 1
            self._append_record(rec)
            return rec
        return self.process_features(feats, timestamp)


class FisheyeStereoVioTracker(InertialMixin, FisheyeStereoTracker):
    """Stereo-inertial fisheye session (a TUM-VI style KB8 rig plus IMU):
    the fisheye left/right association supplies metric depth, so the IMU
    init holds the scale fixed. As in the reference, the map starts with
    the monocular two-view initialization."""

    _imu_optimize_scale = False

    def __init__(self, config: SlamConfig, cam2_params, T_c1_c2,
                 calib: ImuCalib, lapping1=None, lapping2=None, device=None):
        FisheyeStereoTracker.__init__(self, config, cam2_params, T_c1_c2,
                                      lapping1, lapping2, device)
        self._init_inertial(calib)

    def process_stereo_imu(self, featsL, featsR, timestamp, acc, gyro,
                           meas_t) -> FrameRecord:
        depth, has = fisheye_stereo_match(
            featsL, featsR, self.cam_params, self.cam2_params, self.R21,
            self.t21, self.lap1, self.lap2)
        d = torch.clamp(depth, min=1e-6)
        self._cur_uright = torch.where(
            has, featsL.uv[:, 0] - torch.full_like(d, self.bf) / d,
            torch.full_like(d, -1.0))
        self._cur_has_stereo = has & featsL.valid
        return self.process_frame_imu(featsL, timestamp, acc, gyro, meas_t)
