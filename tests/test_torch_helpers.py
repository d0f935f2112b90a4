"""Shared helpers for the PyTorch-port parity tests (no tests here).

Scenes are made with numpy from a seed, built once as a port MapState on
the CPU, and handed to both packages as numpy arrays, so the JAX reference
and the port start from the same state.
"""

import jax.numpy as jnp
import numpy as np
import torch

from orb_slam_fusion_tpu import lie as jlie
from orb_slam_fusion_tpu.frontend.extractor import Features as JFeatures
from orb_slam_fusion_tpu.map.map_state import MapState as JMapState
from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch.map import convert
from orb_slam_fusion_tpu_torch.map import map_state as tms

CPU = "cpu"
CAM_SMALL = (120.0, 120.0, 80.0, 60.0)   # fx, fy, cx, cy for 160x120 images
H_SMALL, W_SMALL = 120, 160


def jax_map(fields):
    """JAX MapState from map_state_to_numpy-style fields."""
    out = {}
    for k in JMapState._fields:
        v = fields[k]
        if k == "kf_pose":
            out[k] = jlie.SE3(jnp.asarray(v[0]), jnp.asarray(v[1]))
        else:
            out[k] = jnp.asarray(v)
    return JMapState(**out)


def jax_map_to_numpy(m):
    out = {}
    for k in JMapState._fields:
        v = getattr(m, k)
        out[k] = ((np.asarray(v.R), np.asarray(v.t)) if k == "kf_pose"
                  else np.asarray(v))
    return out


def jax_features(fields):
    return JFeatures(**{k: jnp.asarray(fields[k]) for k in JFeatures._fields})


def jax_features_to_numpy(f):
    return {k: np.asarray(getattr(f, k)) for k in JFeatures._fields}


def jse3(R, t):
    return jlie.SE3(jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32))


def tse3(R, t):
    return tlie.SE3(torch.from_numpy(np.array(R, np.float32)),
                    torch.from_numpy(np.array(t, np.float32)))


def rot(axis_angle):
    """Rotation matrix (float32) from an axis-angle vector."""
    w = np.asarray(axis_angle, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K
            + (1 - np.cos(th)) * K @ K).astype(np.float32)


def project_features(R, t, pts, desc, obs_rows, F, cam, H, W, rng,
                     noise_px=0.3, flip_bits=2):
    """Synthetic frame: up to F visible points of ``pts`` projected through
    (R, t) with pixel noise, their descriptors with ``flip_bits`` random
    bits flipped, octave 0 or 1. Returns a Features-shaped dict of numpy
    arrays plus the obs row of each slot (``obs_rows`` of the point)."""
    fx, fy, cx, cy = cam
    pc = pts @ R.T + t
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                   fy * pc[:, 1] / pc[:, 2] + cy], axis=1)
    vis = (pc[:, 2] > 0.5) & (uv[:, 0] > 20) & (uv[:, 0] < W - 20) \
        & (uv[:, 1] > 20) & (uv[:, 1] < H - 20)
    rows = np.nonzero(vis)[0]
    rng.shuffle(rows)
    rows = rows[:F]
    n = len(rows)
    f_uv = np.zeros((F, 2), np.float32)
    f_desc = np.zeros((F, 8), np.uint32)
    f_oct = np.zeros(F, np.int32)
    f_val = np.zeros(F, bool)
    obs = np.full(F, -1, np.int32)
    f_uv[:n] = uv[rows] + rng.randn(n, 2).astype(np.float32) * noise_px
    d = desc[rows].copy()
    for _ in range(flip_bits):
        w = rng.randint(0, 8, n)
        b = rng.randint(0, 32, n).astype(np.uint32)
        d[np.arange(n), w] ^= (np.uint32(1) << b)
    f_desc[:n] = d
    f_oct[:n] = (rng.rand(n) < 0.2).astype(np.int32)
    f_val[:n] = True
    obs[:n] = obs_rows[rows]
    feats = dict(uv=f_uv, response=np.ones(F, np.float32), octave=f_oct,
                 angle=np.zeros(F, np.float32), desc=f_desc, valid=f_val)
    return feats, obs


def kf_pose(k):
    """Keyframe k of a scene: a sideways-forward walk with a slow yaw."""
    R = rot([0.0, -0.03 * k, 0.0])
    C = np.array([0.25 * k, 0.02 * k, 0.05 * k], np.float32)
    return R, (-R @ C).astype(np.float32)


def make_scene(seed, M_old=160, M_new=48, F=224, K0=6, max_kf=16, M_cap=512,
               cam=CAM_SMALL, H=H_SMALL, W=W_SMALL):
    """A mapped scene: M_old points in the map, M_new fresh points that
    the K0 keyframes see but leave unbound (so the mapping step has
    something to triangulate). Returns (map fields as numpy, scene dict).

    Every keyframe sees (nearly) every point, so each landmark of a BA
    window is observed from several poses with parallax. A landmark seen
    once in a window has a near-null depth direction that only the LM
    damping bounds; its float32 solution then depends on summation order
    (the port in float32 and in float64 differ as much as the two
    packages do), so such windows cannot be held to a 1e-4 tolerance."""
    rng = np.random.RandomState(seed)
    n_all = M_old + M_new
    pts = np.stack([rng.uniform(-2, 2, n_all), rng.uniform(-1.5, 1.5, n_all),
                    rng.uniform(5, 8, n_all)], axis=1).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, (n_all, 8),
                       dtype=np.uint64).astype(np.uint32)
    obs_rows = np.concatenate([np.arange(M_old, dtype=np.int32),
                               np.full(M_new, -1, np.int32)])
    m = tms.make_empty_map(max_kf, M_cap, F, device=CPU)
    P = torch.from_numpy(pts[:M_old])
    dist = tms.vec_norm(P)
    mn, mx = tms.scale_invariance_band(
        dist, torch.zeros(M_old, dtype=torch.int32), 8)
    m, _ = tms.add_map_points(
        m, P, convert.desc_to_torch(desc[:M_old], CPU), P / dist[:, None],
        0, 0, torch.ones(M_old, dtype=torch.bool), min_dist=mn, max_dist=mx)
    for k in range(K0):
        R, t = kf_pose(k)
        feats, obs = project_features(R, t, pts, desc, obs_rows, F, cam, H,
                                      W, rng, flip_bits=0)
        tf = convert.features_from_numpy(feats, CPU)
        m, _ = tms.add_keyframe(m, tse3(R, t), 0.05 * k, tf.uv, tf.desc,
                                tf.octave, tf.valid, torch.from_numpy(obs))
    scene = dict(pts=pts, desc=desc, obs_rows=obs_rows, rng=rng, cam=cam,
                 H=H, W=W, F=F, K0=K0)
    return convert.map_state_to_numpy(m), scene


def frame_features(scene, R, t, flip_bits=2):
    feats, _ = project_features(R, t, scene["pts"], scene["desc"],
                                scene["obs_rows"], scene["F"], scene["cam"],
                                scene["H"], scene["W"], scene["rng"],
                                flip_bits=flip_bits)
    return feats


def assert_map_close(mj, mt, atol=1e-4, skip=()):
    """Integer/bool/descriptor fields exact; float fields within atol."""
    for k in JMapState._fields:
        if k in skip:
            continue
        a, b = mj[k], mt[k]
        if k == "kf_pose":
            np.testing.assert_allclose(a[0], b[0], atol=atol, err_msg=k)
            np.testing.assert_allclose(a[1], b[1], atol=atol, err_msg=k)
        elif np.issubdtype(np.asarray(a).dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _pose_np(T):
    return (np.asarray(T.R), np.asarray(T.t))


def jax_preintegrated_to_numpy(p):
    if p is None:
        return None
    out = {f: np.asarray(getattr(p, f)) for f in p._fields if f != "bias0"}
    out["bias0"] = (np.asarray(p.bias0.gyro), np.asarray(p.bias0.acc))
    return out


def _bias_np(b):
    return (np.asarray(b.gyro), np.asarray(b.acc))


def jax_inertial_state(tr):
    """A reference inertial tracker's IMU state, in the format of
    ``convert.tracker_state_from_numpy``."""
    pr = tr._prior
    return dict(
        calib={f: np.asarray(getattr(tr.calib, f))
               for f in tr.calib._fields},
        bias=_bias_np(tr.bias), cur_vel=np.asarray(tr.cur_vel),
        gravity_w=np.asarray(tr.gravity_w),
        kf_vel=[np.asarray(v) for v in tr.kf_vel],
        kf_bias=[_bias_np(b) for b in tr.kf_bias],
        kf_pre=[jax_preintegrated_to_numpy(p) for p in tr.kf_pre],
        kf_raw=[None if r is None else tuple(np.asarray(x) for x in r)
                for r in tr.kf_raw],
        kf_time=list(tr.kf_time),
        buf_kf=tuple(list(b) for b in tr._buf_kf),
        pre_frame=jax_preintegrated_to_numpy(tr._pre_frame),
        prev_pose_imu=_pose_np(tr._prev_pose_imu),
        prev_vel_imu=np.asarray(tr._prev_vel_imu),
        prior=None if pr is None else dict(
            pose=_pose_np(pr.pose), vel=np.asarray(pr.vel),
            bg=np.asarray(pr.bg), ba=np.asarray(pr.ba), H=np.asarray(pr.H)),
        imu_stage=tr._imu_stage, imu_init_time=tr._imu_init_time,
        imu_initialized=tr.imu_initialized,
        last_frame_time=tr._last_frame_time)


def _sim3_np(S):
    return (np.asarray(S.s), np.asarray(S.R), np.asarray(S.t))


def jax_loop_state(tr):
    """A reference tracker's loop closer, atlas and relocalization state
    in the format of ``convert.tracker_state_from_numpy`` (empty for a
    tracker without a loop closer)."""
    lc = getattr(tr, "loop_closer", None)
    if lc is None:
        return {}
    pd = lc._pending_detect
    atlas = []
    for a in tr.atlas.archived:
        ai = a.inertial
        if ai is not None:
            ai = dict(kf_vel=[np.asarray(v) for v in ai["kf_vel"]],
                      kf_bias=[_bias_np(b) for b in ai["kf_bias"]],
                      kf_pre=[jax_preintegrated_to_numpy(p)
                              for p in ai["kf_pre"]],
                      kf_time=list(ai["kf_time"]),
                      kf_raw=[None if r is None
                              else tuple(np.asarray(x) for x in r)
                              for r in ai["kf_raw"]])
        atlas.append(dict(map=jax_map_to_numpy(a.map),
                          bow=np.asarray(a.bow),
                          present=np.asarray(a.present), inertial=ai))
    return dict(
        loop_closer=dict(
            bow=np.asarray(lc.db.bow), present=np.asarray(lc.db.present),
            cons_groups=[(sorted(g), c) for g, c in lc._cons_groups],
            loop_edges=[(i, j, _sim3_np(S)) for i, j, S in lc.loop_edges],
            stats=dict(lc.stats), last_loop_kf=lc.last_loop_kf,
            num_closed=lc.num_closed,
            pending_detect=None if pd is None else (
                int(pd[0]), np.asarray(pd[1]), np.asarray(pd[2]),
                np.asarray(pd[3]), np.asarray(pd[4]))),
        atlas=atlas, reloc_grace_frames=tr.reloc_grace_frames,
        merge_cooldown=tr._merge_cooldown)


def jax_tracker_state(tr):
    """A reference MonoTracker's between-frame state as numpy, in the
    format of ``convert.tracker_state_from_numpy`` (with the IMU state of
    an inertial tracker, and the loop closer and atlas of a tracker with
    loop closing). Drains a background local BA, and a global BA, in
    flight first (they do not travel)."""
    tr._lba_drain()
    if getattr(tr, "loop_closer", None) is not None:
        tr.loop_closer.gba_drain(tr)
    dev_stat = tr._last_kf_tracked_dev
    return dict(
        map=jax_map_to_numpy(tr.map), state=tr.state.name,
        cur_pose=_pose_np(tr.cur_pose), velocity=_pose_np(tr.velocity),
        last_pose=None if tr.last_pose is None else _pose_np(tr.last_pose),
        last_kf_id=tr.last_kf_id, last_kf_tracked=tr.last_kf_tracked,
        last_kf_tracked_dev=None if dev_stat is None else int(dev_stat),
        frames_since_kf=tr.frames_since_kf, frame_id=tr.frame_id,
        cur_obs=None if tr._cur_obs is None else np.asarray(tr._cur_obs),
        lost_since=tr.lost_since,
        ref_feats=(None if tr.ref_feats is None
                   else jax_features_to_numpy(tr.ref_feats)),
        ref_timestamp=tr.ref_timestamp,
        traj_rel=[(ts, kf, _pose_np(T)) for ts, kf, T in tr._traj_rel],
        trajectory=[(r.timestamp, _pose_np(r.pose), r.tracked, r.state)
                    for r in tr.trajectory],
        kf_uright=(np.asarray(tr.kf_uright) if hasattr(tr, "kf_uright")
                   else None),
        **(jax_inertial_state(tr) if hasattr(tr, "calib") else {}),
        **jax_loop_state(tr))


_KF_PAD = {"kf_obs_mp": -1, "kf_uright": -1.0}


def _trim_map(m):
    """Map fields cut to their live rows (n_kf keyframes, n_mp points)."""
    K, M = int(m["n_kf"]), int(m["n_mp"])
    out = dict(m, max_kf=m["kf_valid"].shape[0],
               max_mp=m["mp_valid"].shape[0])
    for k, v in m.items():
        if k == "kf_pose":
            out[k] = (v[0][:K], v[1][:K])
        elif k.startswith("kf_"):
            out[k] = v[:K]
        elif k.startswith("mp_"):
            out[k] = v[:M]
    return out


def _pad_rows(v, n, fill):
    v = np.asarray(v)
    pad = np.full((n - v.shape[0],) + v.shape[1:], fill, v.dtype)
    return np.concatenate([v, pad])


def _untrim_map(m):
    Kc, Mc = int(m["max_kf"]), int(m["max_mp"])
    out = {}
    for k, v in m.items():
        if k in ("max_kf", "max_mp"):
            continue
        if k == "kf_pose":
            R = _pad_rows(v[0], Kc, 0.0)
            R[len(v[0]):] = np.eye(3, dtype=R.dtype)
            out[k] = (R, _pad_rows(v[1], Kc, 0.0))
        elif k.startswith("kf_"):
            out[k] = _pad_rows(v, Kc, _KF_PAD.get(k, 0))
        elif k == "mp_max_dist":
            out[k] = _pad_rows(v, Mc, 1e9)
        elif k.startswith("mp_"):
            out[k] = _pad_rows(v, Mc, 0)
        else:
            out[k] = v
    return out


def trim_state(st):
    """A tracker state (``jax_tracker_state``) with every keyframe and
    point table cut to its live rows, for a compact snapshot file;
    ``untrim_state`` pads it back."""
    st = dict(st, map=_trim_map(st["map"]))
    if st.get("kf_uright") is not None:
        st["kf_max"] = st["kf_uright"].shape[0]
        st["kf_uright"] = st["kf_uright"][:int(st["map"]["n_kf"])]
    if st.get("loop_closer") is not None:
        lc = dict(st["loop_closer"])
        lc["kf_max"] = lc["bow"].shape[0]
        n = int(st["map"]["n_kf"])
        lc["bow"], lc["present"] = lc["bow"][:n], lc["present"][:n]
        st["loop_closer"] = lc
        st["atlas"] = [dict(a, map=_trim_map(a["map"]),
                            bow=a["bow"][:int(a["map"]["n_kf"])],
                            present=a["present"][:int(a["map"]["n_kf"])],
                            kf_max=a["bow"].shape[0])
                       for a in st["atlas"]]
    return st


def untrim_state(st):
    st = dict(st, map=_untrim_map(st["map"]))
    if st.get("kf_uright") is not None:
        st["kf_uright"] = _pad_rows(st.pop("kf_uright"), st.pop("kf_max"),
                                    -1.0)
    if st.get("loop_closer") is not None:
        lc = dict(st["loop_closer"])
        K = lc.pop("kf_max")
        lc["bow"] = _pad_rows(lc["bow"], K, 0.0)
        lc["present"] = _pad_rows(lc["present"], K, False)
        st["loop_closer"] = lc
        st["atlas"] = [dict(a, map=_untrim_map(a["map"]),
                            bow=_pad_rows(a["bow"], a["kf_max"], 0.0),
                            present=_pad_rows(a["present"], a["kf_max"],
                                              False))
                       for a in st["atlas"]]
    return st


GOLDENS = __import__("pathlib").Path(__file__).resolve().parent / \
    "torch_goldens"


def load_pickle(name):
    """A gzipped pickle under ``tests/torch_goldens/`` as written."""
    import gzip
    import pickle
    with gzip.open(GOLDENS / name, "rb") as fh:
        return pickle.load(fh)


def load_carried(name):
    """A carried-state snapshot written by ``make_torch_goldens.py``: the
    reference's state before one frame (padded back to its capacities),
    the frame's inputs, and the reference's state and record after it."""
    snap = load_pickle(name)
    snap["before"] = untrim_state(snap["before"])
    return snap


def table_digest(a):
    """A stand-in for an exact table in a snapshot: its dtype, shape and
    SHA-256 (``assert_live_tables`` compares the port's rows to it)."""
    import hashlib
    a = np.ascontiguousarray(a)
    return dict(dtype=str(a.dtype), shape=a.shape,
                sha256=hashlib.sha256(a.tobytes()).hexdigest())


def assert_live_tables(after, mt, atol=1e-4, skip=()):
    """The live rows of a port map against a trimmed reference map:
    integer and boolean tables exactly, descriptors exactly (or their
    ``table_digest``), floats within atol."""
    n_kf, n_mp = int(after["n_kf"]), int(after["n_mp"])
    assert int(mt["n_kf"]) == n_kf and int(mt["n_mp"]) == n_mp
    for k, a in after.items():
        if k in ("max_kf", "max_mp", "n_kf", "n_mp") or k in skip:
            continue
        b = mt[k]
        if k == "kf_pose":
            for x, y in zip(a, b):
                np.testing.assert_allclose(y[:n_kf], x, atol=atol,
                                           err_msg=k)
            continue
        b = b[:n_kf] if k.startswith("kf_") else b[:n_mp]
        if isinstance(a, dict):
            assert table_digest(np.asarray(b, a["dtype"])) == a, k
        elif np.issubdtype(np.asarray(a).dtype, np.floating):
            np.testing.assert_allclose(b, a, atol=atol, rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def with_threads(n, fn):
    """``fn()`` with ``n`` torch threads, the count restored after (test
    files set 1 when imported: a test's thread count decides some float32
    sums, and xdist workers import every file before running any)."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


def window_edge_scene(fused_inside, n=32, r=15.0, seed=0):
    """Map points at z = 1 under the identity pose and a unit pinhole, so
    they project to their own (x, y) exactly, each with one keypoint at an
    exact offset (du, dv) whose squared distance, rounded as XLA:CPU fuses
    it (``fma(dv, dv, du*du)``) and rounded term by term, falls on either
    side of ``r*r``: inside by the fused rounding only (``fused_inside``)
    or by the term-by-term one only. The keypoint carries its map point's
    descriptor; the points sit 40 px apart, one keypoint per window.
    Returns (mp_pos (n, 3), desc (n, 8) uint32, kp_uv (n, 2))."""
    f32 = np.float32
    rng = np.random.RandomState(seed)
    r2 = f32(r) * f32(r)
    q = 2.0 ** 14       # offsets on a 2^-14 grid: uv - kp exact below 1024
    du = (np.round(rng.uniform(0.3, 0.95, 400000) * r * q) / q).astype(f32)
    dv0 = np.sqrt(np.float64(r2) - du.astype(np.float64) ** 2)
    dv = (np.round(dv0[:, None] * q + np.arange(-8, 9)[None]) / q).astype(
        f32)
    du2 = (du * du)[:, None]
    sep = (du2 + dv * dv).astype(f32)
    fused = (dv.astype(np.float64) ** 2 + du2.astype(np.float64)).astype(f32)
    hit = ((fused <= r2) & (r2 < sep)) if fused_inside else \
        ((sep <= r2) & (r2 < fused))
    rows = np.nonzero(hit.any(1))[0][:n]
    assert len(rows) == n
    d = np.stack([du[rows], dv[rows, hit[rows].argmax(1)]], 1)
    gx, gy = np.meshgrid(np.arange(16), np.arange(n // 16 + 1))
    uv = np.stack([100 + 40 * gx.ravel()[:n], 100 + 40 * gy.ravel()[:n]],
                  1).astype(f32)
    kp = (uv - d).astype(f32)
    assert ((uv - kp) == d).all()
    desc = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([uv, np.ones((n, 1), f32)], 1), desc, kp
