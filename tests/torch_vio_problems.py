"""Seeded visual-inertial solver problems (numpy and the port only, no
JAX): the CPU parity tests hand them to both packages, the card tests to
the port on the CPU and on the card. No tests here. Also the loader of
the VIBA1 keyframe's recorded solver calls."""

import pathlib

import numpy as np
import torch

from orb_slam_fusion_tpu_torch import lie as tlie
from orb_slam_fusion_tpu_torch import sim as tsim
from orb_slam_fusion_tpu_torch.imu import preintegration as tp
from orb_slam_fusion_tpu_torch.imu.factors import information_from_cov
from orb_slam_fusion_tpu_torch.solver import ba as tba
from orb_slam_fusion_tpu_torch.solver import vi_ba as tvi

CAM = (400.0, 400.0, 376.0, 240.0)
BF = 0.11 * 400.0


def seeded(seed, stereo, K=8, step=3, M=90, pose_noise=1.0):
    """Keyframes every ``step`` frames of a short VIO sequence with their
    host preintegrations, noisy observations of M points, perturbed
    poses/velocities. Returns numpy dicts."""
    rng = np.random.RandomState(seed)
    seq = tsim.make_vio_sequence(n_frames=K * step + 1, seed=seed,
                                 gyro_noise=1.7e-4, acc_noise=2e-3,
                                 gyro_bias=0.002, acc_bias=0.02)
    frames = np.arange(K) * step
    R = seq.world.poses.R[frames]
    t = seq.world.poses.t[frames]
    centers = -np.einsum("kji,kj->ki", R, t)
    mid = centers.mean(0)
    fwd = R[0][2]                        # camera z axis in world
    pts = (mid + fwd * 6.0 + rng.uniform(-3, 3, (M, 3))).astype(np.float32)
    kf_idx = np.repeat(np.arange(K), M).astype(np.int32)
    mp_idx = np.tile(np.arange(M), K).astype(np.int32)
    pc = np.einsum("fij,fj->fi", R[kf_idx], pts[mp_idx]) + t[kf_idx]
    uv = np.stack([CAM[0] * pc[:, 0] / pc[:, 2] + CAM[2],
                   CAM[1] * pc[:, 1] / pc[:, 2] + CAM[3]], 1)
    valid = ((pc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 752)
             & (uv[:, 1] > 0) & (uv[:, 1] < 480) & (rng.rand(len(uv)) > 0.1))
    uv = (uv + rng.randn(*uv.shape) * 0.5).astype(np.float32)
    ur = (uv[:, 0] - BF / np.maximum(pc[:, 2], 1e-3)
          + rng.randn(len(uv)) * 0.5).astype(np.float32)
    smask = valid & (rng.rand(len(uv)) > 0.3) if stereo else None
    raws = []
    for a, b in zip(frames[:-1], frames[1:]):
        acc = np.concatenate([seq.frame_imu[f][0] for f in range(a, b)])
        gyr = np.concatenate([seq.frame_imu[f][1] for f in range(a, b)])
        raws.append((acc, gyr, np.full(len(acc), 1.0 / 200.0)))
    Rn = np.stack([r @ rotvec(rng.randn(3) * 0.01 * pose_noise + 1e-12)
                   for r in R]).astype(
        np.float32)
    tn = (t + rng.randn(*t.shape) * 0.02 * pose_noise).astype(np.float32)
    vel = (seq.vel[frames] + rng.randn(K, 3) * 0.05).astype(np.float32)
    pts_n = (pts + rng.randn(*pts.shape) * 0.02).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(R=Rn, t=tn, vel=vel, pts=pts_n, kf_idx=kf_idx, mp_idx=mp_idx,
                uv=uv, valid=valid, ur=ur, smask=smask, raws=raws,
                fixed=fixed, inv_s2=np.where(rng.rand(len(uv)) < 0.2,
                                             1 / 1.44, 1.0).astype(
                                                 np.float32))


def rotvec(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def port_problem(d, stereo, device):
    """(state, problem, factors, calib) of ``seeded``'s dict for the port
    on ``device``."""
    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    K = d["R"].shape[0]
    calib = tp.make_calib(device=device)
    z = torch.zeros(3, device=device)
    pres = [tp.preintegrate_host(*r, tp.ImuBias(z, z), calib)
            for r in d["raws"]]
    pre = tp.stack_preintegrated(pres)
    P = len(pres)
    ii = torch.arange(P, dtype=torch.int32, device=device)
    ifac = tvi.InertialFactorBatch(i=ii, j=ii + 1, pre=pre,
                                   info=information_from_cov(pre),
                                   valid=torch.ones(P, dtype=torch.bool,
                                                    device=device))
    st = {}
    if stereo:
        st = dict(u_right=t(d["ur"]), stereo_mask=t(d["smask"]), bf=BF)
    poses = tlie.SE3(t(d["R"]), t(d["t"]))
    prob = tba.make_problem(poses, t(d["pts"]), t(d["kf_idx"]),
                            t(d["mp_idx"]), t(d["uv"]), t(d["inv_s2"]),
                            t(d["valid"]), t(d["fixed"]),
                            torch.tensor(CAM, device=device), max_obs=K,
                            **st)
    zK = torch.zeros(K, 3, device=device)
    state = tvi.VIState(poses, t(d["vel"]), zK, zK.clone())
    return state, prob, ifac, calib


# ---------------------------------------------------------------------------
# the VIBA1 keyframe's solver calls (torch_goldens/viba1_solver_calls.npz)
# ---------------------------------------------------------------------------

VIBA1_GOLDEN = (pathlib.Path(__file__).resolve().parent / "torch_goldens"
                / "viba1_solver_calls.npz")
VIBA1_CALLS = ("init", "full")     # inertial_init, then the full VI-BA


def flatten(tree, prefix=""):
    """Nested dicts and lists of arrays and scalars -> {"a/0/b": array};
    None leaves are left out."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten(flat):
    """The inverse of ``flatten``: lists where every key is an index."""
    root = {}
    for key, v in flat.items():
        node, parts = root, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(n):
        if not isinstance(n, dict):
            return n
        n = {k: fix(v) for k, v in n.items()}
        if n and all(k.isdigit() for k in n):
            return [n[str(i)] for i in range(len(n))]
        return n
    return fix(root)


def load_viba1_golden(path=VIBA1_GOLDEN):
    """{"init"|"full": {"args": [args, kwargs], "result": ...}} of the
    reference's VIBA1 keyframe, as ``torch_viba1_replay.py --write-golden``
    wrote them."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def _port_tree(cls, d, device):
    """A port NamedTuple from a recorded dict (fields by name; missing
    fields keep their defaults)."""
    nested = {"poses": tlie.SE3, "pre": tp.Preintegrated,
              "bias0": tp.ImuBias}
    kw = {}
    for f in cls._fields:
        if f not in d:
            continue
        v = d[f]
        if isinstance(v, dict):
            kw[f] = _port_tree(nested[f], v, device)
        elif v.dtype.kind in "fbiu":
            kw[f] = torch.from_numpy(np.array(v)).to(device)
        else:
            kw[f] = v.item()
    return cls(**kw)


def viba1_args(entry, device):
    """The port's (args, kwargs) of a recorded call (``init`` or
    ``full``) on ``device``."""
    args, kw = entry["args"]
    kw = {k: (torch.from_numpy(np.array(v)).to(device)
              if v.dtype == bool and v.ndim else v.item())
          for k, v in kw.items()}
    if "fixed_pose" in kw:
        state, prob, ifac, calib = args
        return (_port_tree(tvi.VIState, state, device),
                _port_tree(tba.BAProblem, prob, device),
                _port_tree(tvi.InertialFactorBatch, ifac, device),
                _port_tree(tp.ImuCalib, calib, device)), kw
    poses, ifac, calib = args
    return (_port_tree(tlie.SE3, poses, device),
            _port_tree(tvi.InertialFactorBatch, ifac, device),
            _port_tree(tp.ImuCalib, calib, device)), kw


def viba1_solution(result, name):
    """The compared part of a solver's result (numpy): an init's scale and
    velocities, a VI-BA's keyframe positions; and its candidate costs."""
    def a(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    if name == "init":
        return (np.concatenate([a(result[0]).reshape(1),
                                a(result[3]).reshape(-1)]), a(result[4]))
    poses = result[0]["poses"] if isinstance(result[0], dict) \
        else result[0].poses
    t = poses["t"] if isinstance(poses, dict) else poses.t
    return a(t), a(result[2])
