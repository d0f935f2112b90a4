"""Problems and fixtures shared by ``chip_smoke.py`` and the port's tests.

Numpy and the port only (no JAX), so the card-side script can import it:
``ba_problem_arrays`` builds ``tests/test_ba_cg.py``'s multi-view BA
problem, ``load_loop_map``/``close_loop_map`` load the drifted loop map
snapshot (``tests/torch_goldens/loop_map_20kf.npz``) into the port's
``LoopCloser`` with ``test_loop_closing_e2e.py``'s facade tracker and
drive it.
"""


def ba_problem_arrays(K, nf, M, spacing, n_fixed, seed=0, noise=0.05):
    """tests/test_ba_cg.py's consistent multi-view problem in the window-
    contiguous factor layout (kf_idx[f] == f // nf) that the PCG global
    BA solves, as numpy: K poses along a line ``spacing`` apart, M points
    12 m ahead, nf observations per keyframe with 0.4 px noise, 5 cm of
    pose and point noise, the first ``n_fixed`` poses fixed."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-6, 6, (M, 3)).astype(np.float32) + [0, 0, 12]
    F = K * nf
    kf_idx = np.repeat(np.arange(K, dtype=np.int32), nf)
    Cs = np.stack([spacing * np.arange(K), 0.2 * spacing * np.arange(K),
                   0.4 * spacing * np.arange(K)], 1).astype(np.float32)
    ts = -Cs
    Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (K, 3, 3)).copy()
    mp_idx = np.zeros(F, np.int32)
    uv = np.zeros((F, 2), np.float32)
    valid = np.zeros(F, bool)
    for k in range(K):
        pc = pts + ts[k]
        u = 400 * pc[:, 0] / pc[:, 2] + 376
        v = 400 * pc[:, 1] / pc[:, 2] + 240
        vis = (pc[:, 2] > 1) & (u > 0) & (u < 752) & (v > 0) & (v < 480)
        rows = np.nonzero(vis)[0]
        rng.shuffle(rows)
        rows = rows[:nf]
        sl = slice(k * nf, k * nf + len(rows))
        mp_idx[sl] = rows
        uv[sl] = np.stack([u[rows], v[rows]], 1) + rng.randn(len(rows),
                                                             2) * 0.4
        valid[sl] = True
    t_n = (ts + rng.randn(K, 3).astype(np.float32) * noise).astype(
        np.float32)
    pts_n = (pts + rng.randn(M, 3).astype(np.float32) * noise).astype(
        np.float32)
    fixed = np.zeros(K, bool)
    fixed[:n_fixed] = True
    return dict(R=Rs, t=t_n, pts=pts_n, kf_idx=kf_idx, mp_idx=mp_idx,
                uv=uv.astype(np.float32), inv_s2=np.ones(F, np.float32),
                valid=valid, fixed=fixed,
                cam=np.array([400.0, 400.0, 376.0, 240.0], np.float32))


def ba_problem(a, dev):
    import torch
    from orb_slam_fusion_tpu_torch import lie
    from orb_slam_fusion_tpu_torch.solver import ba

    def T(x):
        return torch.from_numpy(x).to(dev)
    return ba.make_problem(
        lie.SE3(T(a["R"]), T(a["t"])), T(a["pts"]), T(a["kf_idx"]),
        T(a["mp_idx"]), T(a["uv"]), T(a["inv_s2"]), T(a["valid"]),
        T(a["fixed"]), T(a["cam"]), max_obs=16)


class LoopFacade:
    """tests/test_loop_closing_e2e.py's minimal tracker for a LoopCloser:
    a map, the camera, the newest keyframe."""

    def __init__(self, m, cam, last_kf_id, dev):
        import torch
        from orb_slam_fusion_tpu_torch import lie
        self.map = m
        self.cam_params = torch.tensor(cam, dtype=torch.float32, device=dev)
        self.last_kf_id = last_kf_id
        self.cur_pose = lie.SE3(m.kf_pose.R[last_kf_id],
                                m.kf_pose.t[last_kf_id])
        self.velocity = lie.se3_identity(device=dev)
        self._pending_lba = None

    def _reset_prior(self):
        pass


def loop_pair(fields, cam, n_feat, max_kf, max_mp, dev, vocab_path=None,
              **closer_kw):
    """A facade tracker on a map (``map_state_from_numpy`` fields) and a
    LoopCloser with every keyframe in its database: (tracker, closer)."""
    from orb_slam_fusion_tpu_torch.engine import SlamConfig
    from orb_slam_fusion_tpu_torch.engine.loop_closing import LoopCloser
    from orb_slam_fusion_tpu_torch.frontend.extractor import OrbParams
    from orb_slam_fusion_tpu_torch.map import convert
    m = convert.map_state_from_numpy(fields, dev)
    cfg = SlamConfig(cam_params=tuple(cam), image_size=(480, 752),
                     orb=OrbParams(n_features=n_feat), max_keyframes=max_kf,
                     max_map_points=max_mp, vocab_path=vocab_path)
    K = int(m.n_kf)
    tracker = LoopFacade(m, tuple(cam), K - 1, dev)
    closer = LoopCloser(cfg, max_kf, device=dev, **closer_kw)
    for k in range(K):
        closer.add_keyframe(k, m.kf_desc[k], m.kf_feat_valid[k])
    return tracker, closer


def load_loop_map(path, dev, **pair_kw):
    """The drifted loop map (the npz at ``path``) on ``dev``: (facade
    tracker, a LoopCloser with every keyframe in its database, by default
    over the flat 2,048-word vocabulary, the file's arrays)."""
    import numpy as np
    z = dict(np.load(path))
    fields = {k[4:]: v for k, v in z.items() if k.startswith("map.")
              and not k.startswith("map.kf_pose")}
    fields["kf_pose"] = (z["map.kf_pose.R"], z["map.kf_pose.t"])
    pair_kw = pair_kw or dict(vocab_words=2048)
    tracker, closer = loop_pair(
        fields, [float(v) for v in z["cam"]], int(z["n_feat"]),
        int(z["max_keyframes"]), int(z["max_map_points"]), dev, **pair_kw)
    return tracker, closer, z


def close_loop_map(tracker, closer, z):
    """The e2e test's drive: the last five keyframes offered to the closer
    one by one, then the global BA drained. Returns the results."""
    import numpy as np
    from orb_slam_fusion_tpu_torch import lie
    K = int(tracker.map.n_kf)
    out = dict(closed_at=None)
    for k in range(max(0, K - 5), K):
        tracker.last_kf_id = k
        tracker.cur_pose = lie.SE3(tracker.map.kf_pose.R[k],
                                   tracker.map.kf_pose.t[k])
        if closer.try_close(tracker):
            out["closed_at"] = k
            out["corrected_R"] = tracker.map.kf_pose.R.cpu().numpy()
            out["corrected_t"] = tracker.map.kf_pose.t.cpu().numpy()
    closer.gba_drain(tracker)
    out["edges"] = [(i, j) for i, j, _ in closer.loop_edges]
    out["edge"] = list(out["edges"][0]) if out["edges"] else None
    if closer.loop_edges:
        S = closer.loop_edges[0][2]
        out["edge_S"] = [np.asarray(x.cpu().numpy()) for x in S]
    out["stats"] = dict(closer.stats)
    out["R"] = tracker.map.kf_pose.R.cpu().numpy()
    out["t"] = tracker.map.kf_pose.t.cpu().numpy()
    return out


# The PCG step's linearization from the reference's states (ROADMAP C14b):
# ``torch_pcg_replay.py --write-golden`` writes the host port's sums at
# two LM iterations of test_torch_ba_cg.py's five (iteration 0 weighs 846
# of its 1,536 factors below one, through the Huber weight's rsqrt), the
# card is held to them by ``chip_smoke.py`` and the golden to the
# reference by ``test_torch_pcg_order.py``.
PCG_GOLDEN = "pcg_linearization.npz"
PCG_GOLDEN_ITERS = (0, 2)
PCG_GOLDEN_SUMS = ("r", "Jp", "Jl", "Hll", "gl", "Hll_inv", "Hpp", "g_r")


def load_pcg_golden():
    import os

    import numpy as np
    return np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "torch_goldens", PCG_GOLDEN))


def pcg_problem(g, dev):
    """The golden's BA problem (``ba_problem_arrays`` at its shape) on
    ``dev``."""
    import json
    return ba_problem(ba_problem_arrays(**json.loads(str(g["shape"]))), dev)


def pcg_port_sums(prob, g, dev):
    """The port's PCG linearization on ``dev`` from each of the golden's
    states, each stage from the port's own previous one, and the step's
    points with ``cg_iters=0``: {"<sum>_<iteration>": numpy array}."""
    import json

    import numpy as np
    import torch
    from orb_slam_fusion_tpu_torch import lie
    from orb_slam_fusion_tpu_torch.solver import ba

    stride = json.loads(str(g["shape"]))["nf"]
    out = {}
    for it in PCG_GOLDEN_ITERS:
        def T(k):
            return torch.from_numpy(np.array(g[f"{k}_{it}"])).to(dev)
        poses, X, lam = lie.SE3(T("R"), T("t")), T("X"), T("lam")
        r, Jp, Jl, depth_ok = ba._pcg_factors(poses, X, prob, "pinhole")
        w = ba._pcg_weights(r, prob.valid & depth_ok, prob, float(g["chi2"]),
                            True)
        Hll, gl, Hll_inv = ba._pcg_landmark_system(r, Jl, w, prob, lam)
        Hpp, g_r, _ = ba._pcg_pose_system(r, Jp, Jl, w, Hll_inv, gl, prob,
                                          stride)
        X0 = ba._lm_step_cg(poses, X, lam, torch.ones_like(prob.valid), prob,
                            "pinhole", float(g["chi2"]), True, stride,
                            cg_iters=0)[1]
        for k, v in dict(r=r, Jp=Jp, Jl=Jl, Hll=Hll, gl=gl, Hll_inv=Hll_inv,
                         Hpp=Hpp, g_r=g_r, cg0_X=X0).items():
            out[f"{k}_{it}"] = v.cpu().numpy()
    return out
