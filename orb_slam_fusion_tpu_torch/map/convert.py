"""Carry state between the JAX package and the port as numpy arrays.

The port never imports JAX; a caller converts the reference's arrays with
``np.asarray`` first. A ``MapState``, ``Features`` or ``SE3`` travels as a
dict (or tuple) of numpy arrays named after the fields, with poses as
``(R, t)`` pairs. uint32 descriptors become int32 bit patterns on the way
in and uint32 again on the way out.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import lie, resolve_device
from ..frontend.extractor import Features
from .map_state import MapState

_DESC_FIELDS = ("kf_desc", "mp_desc", "desc")


def desc_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """uint32 descriptor words -> int32 bit-pattern tensor."""
    a = np.array(a, dtype=np.uint32, order="C")   # keeps 0-d shapes
    return torch.from_numpy(a.view(np.int32)).to(device)


def desc_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> uint32 descriptor words."""
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _to_torch(name: str, a, device) -> torch.Tensor:
    if name in _DESC_FIELDS:
        return desc_to_torch(a, device)
    a = np.array(a, order="C")                    # a copy; keeps 0-d shapes
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    if name in _DESC_FIELDS:
        return desc_to_numpy(t)
    return t.detach().cpu().numpy()


def se3_from_numpy(pose, device=None) -> lie.SE3:
    """(R, t) numpy pair -> SE3 of tensors."""
    dev = resolve_device(device)
    return lie.SE3(_to_torch("R", pose[0], dev), _to_torch("t", pose[1], dev))


def se3_to_numpy(pose: lie.SE3):
    return (pose.R.detach().cpu().numpy(), pose.t.detach().cpu().numpy())


def map_state_from_numpy(fields: Dict[str, object], device=None) -> MapState:
    """MapState from a dict of numpy arrays keyed by field name
    (``kf_pose`` as an (R, t) pair)."""
    dev = resolve_device(device)
    out = {}
    for name in MapState._fields:
        if name == "kf_pose":
            out[name] = se3_from_numpy(fields[name], dev)
        else:
            out[name] = _to_torch(name, fields[name], dev)
    for name in ("n_kf", "n_mp", "kf_obs_mp", "kf_octave", "mp_ref_kf",
                 "mp_visible", "mp_found", "mp_first_kf"):
        out[name] = out[name].to(torch.int32)
    return MapState(**out)


def map_state_to_numpy(m: MapState) -> Dict[str, object]:
    out = {}
    for name in MapState._fields:
        v = getattr(m, name)
        out[name] = se3_to_numpy(v) if name == "kf_pose" else _to_numpy(
            name, v)
    return out


def features_from_numpy(fields: Dict[str, np.ndarray], device=None
                        ) -> Features:
    dev = resolve_device(device)
    return Features(**{n: _to_torch(n, fields[n], dev)
                       for n in Features._fields})


def features_to_numpy(f: Features) -> Dict[str, np.ndarray]:
    return {n: _to_numpy(n, getattr(f, n)) for n in Features._fields}


def preintegrated_from_numpy(fields: Dict[str, object], device=None):
    """A ``Preintegrated`` from a dict of numpy arrays keyed by field name
    (``bias0`` as a (gyro, acc) pair); float32 tensors on ``device``."""
    from ..imu.preintegration import ImuBias, Preintegrated
    dev = resolve_device(device)
    out = {n: _to_torch(n, np.asarray(fields[n], np.float32), dev)
           for n in Preintegrated._fields if n != "bias0"}
    g, a = fields["bias0"]
    return Preintegrated(bias0=ImuBias(
        _to_torch("g", np.asarray(g, np.float32), dev),
        _to_torch("a", np.asarray(a, np.float32), dev)), **out)


def _inertial_state_from_numpy(tracker, state: Dict[str, object]) -> None:
    """The inertial part of ``tracker_state_from_numpy``."""
    from ..imu.preintegration import ImuCalib
    from ..solver.pose_inertial_prior import PoseImuPrior

    dev = tracker.device

    def t(name, a):
        return _to_torch(name, np.asarray(a, np.float32), dev)

    def pre(p):
        return None if p is None else preintegrated_from_numpy(p, dev)

    c = state["calib"]
    tracker.calib = ImuCalib(**{n: t(n, c[n]) for n in ImuCalib._fields})
    tracker.bias = _bias_from_numpy(state["bias"], dev)
    tracker.cur_vel = t("v", state["cur_vel"])
    tracker.gravity_w = t("g", state["gravity_w"])
    tracker.kf_vel = [np.array(v, np.float32) for v in state["kf_vel"]]
    tracker.kf_bias = [_bias_from_numpy(b, dev) for b in state["kf_bias"]]
    tracker.kf_pre = [pre(p) for p in state["kf_pre"]]
    tracker.kf_raw = [None if r is None else tuple(
        np.array(x, np.float64) for x in r) for r in state["kf_raw"]]
    tracker.kf_time = [float(x) for x in state["kf_time"]]
    tracker._buf_kf = tuple(np.asarray(b, np.float64).tolist()
                            for b in state["buf_kf"])
    tracker._pre_frame = pre(state["pre_frame"])
    tracker._prev_pose_imu = se3_from_numpy(state["prev_pose_imu"], dev)
    tracker._prev_vel_imu = t("v", state["prev_vel_imu"])
    pr = state["prior"]
    tracker._prior = None if pr is None else PoseImuPrior(
        pose=se3_from_numpy(pr["pose"], dev), vel=t("v", pr["vel"]),
        bg=t("g", pr["bg"]), ba=t("a", pr["ba"]), H=t("H", pr["H"]))
    tracker._imu_stage = int(state["imu_stage"])
    tracker._imu_init_time = float(state["imu_init_time"])
    tracker.imu_initialized = bool(state["imu_initialized"])
    lt = state["last_frame_time"]
    tracker._last_frame_time = None if lt is None else float(lt)


def _bias_from_numpy(b, dev):
    from ..imu.preintegration import ImuBias
    return ImuBias(_to_torch("g", np.asarray(b[0], np.float32), dev),
                   _to_torch("a", np.asarray(b[1], np.float32), dev))


def sim3_from_numpy(S, device=None):
    """(s, R, t) numpy triple -> Sim3 of float32 tensors."""
    dev = resolve_device(device)
    return lie.Sim3(*(_to_torch("s", np.asarray(x, np.float32), dev)
                      for x in S))


def _loop_closer_from_numpy(lc, st: Dict[str, object], dev) -> None:
    """The loop closer's state: its database rows, consistency groups,
    loop edges, counters and the detection deferred to the next
    keyframe."""
    lc.db.bow = _to_torch("bow", np.asarray(st["bow"], np.float32), dev)
    lc.db.present = _to_torch("present", np.asarray(st["present"], bool),
                              dev)
    lc._cons_groups = [(frozenset(int(k) for k in g), int(c))
                       for g, c in st["cons_groups"]]
    lc.loop_edges = [(int(i), int(j), sim3_from_numpy(S, dev))
                     for i, j, S in st["loop_edges"]]
    lc.stats = dict(st["stats"])
    lc.last_loop_kf = int(st["last_loop_kf"])
    lc.num_closed = int(st["num_closed"])
    pd = st["pending_detect"]
    lc._pending_detect = None if pd is None else (
        int(pd[0]), _to_torch("ids", np.asarray(pd[1], np.int32), dev),
        _to_torch("groups", np.asarray(pd[2], bool), dev),
        _to_torch("scores", np.asarray(pd[3], np.float32), dev),
        _to_torch("n", np.asarray(pd[4], np.int32), dev))
    lc.pending_gba = None


def _archived_map_from_numpy(a: Dict[str, object], dev):
    """An ``ArchivedMap`` from numpy; its inertial tables (if any) as in
    ``tracker_state_from_numpy``."""
    from .atlas import ArchivedMap
    inertial = a.get("inertial")
    if inertial is not None:
        inertial = dict(
            kf_vel=[np.array(v, np.float32) for v in inertial["kf_vel"]],
            kf_bias=[_bias_from_numpy(b, dev) for b in inertial["kf_bias"]],
            kf_pre=[None if p is None else preintegrated_from_numpy(p, dev)
                    for p in inertial["kf_pre"]],
            kf_time=[float(x) for x in inertial["kf_time"]],
            kf_raw=[None if r is None else tuple(
                np.array(x, np.float64) for x in r)
                for r in inertial["kf_raw"]])
    return ArchivedMap(
        map_state_from_numpy(a["map"], dev),
        _to_torch("bow", np.asarray(a["bow"], np.float32), dev),
        _to_torch("present", np.asarray(a["present"], bool), dev),
        inertial)


def tracker_state_from_numpy(tracker, state: Dict[str, object]) -> None:
    """Load a session's state, as numpy, into a port ``MonoTracker``.

    ``state`` holds what a reference ``MonoTracker`` carries between frames,
    with poses as (R, t) pairs: ``map`` (``map_state_to_numpy`` fields),
    ``state`` (a ``TrackState`` name), ``cur_pose``, ``velocity``,
    ``last_pose`` (or None), ``last_kf_id``, ``last_kf_tracked``,
    ``last_kf_tracked_dev`` (the deferred mapping statistic, or None),
    ``frames_since_kf``, ``frame_id``, ``cur_obs`` (or None), ``lost_since``,
    ``ref_feats`` (Features fields, or None), ``ref_timestamp``,
    ``traj_rel`` ([(timestamp, kf, (R, t))]) and ``trajectory``
    ([(timestamp, (R, t), tracked, state string)]); a stereo session's
    state also holds ``kf_uright`` (K, F), its per-keyframe right-image u
    table. An inertial session's state (``calib`` present) also holds
    ``calib`` (``ImuCalib`` fields), ``bias`` and each of ``kf_bias`` as
    (gyro, acc) pairs, ``cur_vel``, ``gravity_w``, ``kf_vel``, ``kf_pre``
    and ``pre_frame`` (``Preintegrated`` dicts or None), ``kf_raw``
    ((acc, gyro, dt) or None), ``kf_time``, ``buf_kf`` (the three sample
    lists since the last keyframe), ``prev_pose_imu``, ``prev_vel_imu``,
    ``prior`` (a dict of the ``PoseImuPrior`` fields, or None),
    ``imu_stage``, ``imu_init_time``, ``imu_initialized`` and
    ``last_frame_time``. A session with a loop closer also carries
    ``loop_closer``: its database (``bow`` (K, V), ``present``),
    ``cons_groups`` ([(keyframe rows, count)]), ``loop_edges``
    ([(i, j, (s, R, t))]), ``stats``, ``last_loop_kf``, ``num_closed``
    and ``pending_detect`` (None, or (kf_id, ids, groups, scores,
    n_elig)); ``atlas``, the archived maps ([{map, bow, present,
    inertial}], ``inertial`` None or the lists ``kf_vel``, ``kf_bias``,
    ``kf_pre``, ``kf_time``, ``kf_raw`` in the formats above),
    ``reloc_grace_frames`` and ``merge_cooldown``. A background local or
    global BA in flight does not travel: drain it on the source side
    first.
    """
    from ..engine.tracker import FrameRecord, TrackState

    dev = tracker.device
    tracker._pending_lba = None
    tracker.map = map_state_from_numpy(state["map"], dev)
    tracker.state = TrackState[state["state"]]
    tracker.cur_pose = se3_from_numpy(state["cur_pose"], dev)
    tracker.velocity = se3_from_numpy(state["velocity"], dev)
    tracker.last_pose = (None if state["last_pose"] is None
                         else se3_from_numpy(state["last_pose"], dev))
    tracker.last_kf_id = int(state["last_kf_id"])
    tracker.last_kf_tracked = int(state["last_kf_tracked"])
    dev_stat = state["last_kf_tracked_dev"]
    tracker._last_kf_tracked_dev = (
        None if dev_stat is None
        else torch.tensor(int(dev_stat), dtype=torch.int32, device=dev))
    tracker.frames_since_kf = int(state["frames_since_kf"])
    tracker.frame_id = int(state["frame_id"])
    obs = state["cur_obs"]
    tracker._cur_obs = (None if obs is None else
                        torch.from_numpy(np.array(obs, np.int32)).to(dev))
    tracker.lost_since = int(state["lost_since"])
    ref = state["ref_feats"]
    tracker.ref_feats = None if ref is None else features_from_numpy(ref,
                                                                     dev)
    tracker.ref_timestamp = float(state["ref_timestamp"])
    tracker._traj_rel = [(float(ts), int(kf), se3_from_numpy(T, dev))
                         for ts, kf, T in state["traj_rel"]]
    tracker.trajectory = [FrameRecord(float(ts), se3_from_numpy(T, dev),
                                      int(n), str(s))
                          for ts, T, n, s in state["trajectory"]]
    if state.get("kf_uright") is not None:
        tracker.kf_uright = _to_torch("kf_uright", state["kf_uright"], dev)
    if state.get("calib") is not None:
        _inertial_state_from_numpy(tracker, state)
    if state.get("loop_closer") is not None:
        _loop_closer_from_numpy(tracker.loop_closer, state["loop_closer"],
                                dev)
    if state.get("atlas") is not None:
        tracker.atlas.archived = [_archived_map_from_numpy(a, dev)
                                  for a in state["atlas"]]
    if state.get("reloc_grace_frames") is not None:
        tracker.reloc_grace_frames = int(state["reloc_grace_frames"])
    if state.get("merge_cooldown") is not None:
        tracker._merge_cooldown = int(state["merge_cooldown"])
