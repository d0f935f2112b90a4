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
