"""The card against the host on the first frames of ``chip_smoke.py``'s
fisheye stereo session (ROADMAP C14a)::

    python tests/torch_fisheye_card_check.py [--frames N]

Needs a CUDA device; run it from the repository's root. For each frame it
renders the KB8 pair as ``chip_smoke.run_fisheye_sessions`` does, then
prints how many rows differ in any bit between the card and the host
CPU: the port's KB8 unprojection of both images (``tan`` and the fused
Newton loop of ``utils/libm.py``), the KB8 projection and its Jacobian of
the host's rays (``atan2``), ``cameras.triangulate`` (exact and
``exact=False``) of the host's rays, and the depths and accepted masks of
``fisheye_stereo_match`` on each device's own features. Then, per call
site of ROADMAP C15's table, the rows of 512 seeded tangents where the
card and the host differ (``so3_exp`` and the left Jacobian take the
library's sin and cos, the others ``libm``). Imports no JAX. A few
seconds.
"""

import argparse
import os
import sys

import numpy as np


def _rows_differ(a, b) -> int:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                      & np.isnan(b))
    return int((~same.all(-1)).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    a = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    import chip_smoke as cs
    from orb_slam_fusion_tpu_torch import cameras, sim
    from orb_slam_fusion_tpu_torch.frontend import stereo

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(cs._card_line(), flush=True)
    cfg = cs._config(cs.FISHEYE_CONFIG)
    world = sim.make_corridor_world(**cs.FISHEYE_STEREO_WORLD)
    r = dict(cs.FISHEYE_STEREO_RENDER)
    nf = r.pop("n_features")
    T12 = np.asarray(cs.T_C1_C2)
    T21 = np.linalg.inv(T12)
    host = dict(cam=torch.tensor(cfg.cam_params, dtype=torch.float32),
                R21=torch.from_numpy(T21[:3, :3].astype(np.float32)),
                t21=torch.from_numpy(T21[:3, 3].astype(np.float32)))
    card = {k: v.cuda() for k, v in host.items()}
    kb8 = cameras.KANNALA_BRANDT8
    lap = ((0.0, 1e9), (0.0, 1e9))
    for k in range(a.frames):
        pair = sim.render_fisheye_stereo_frame_numpy(
            world, k, cfg.cam_params, cfg.cam_params, cfg.image_size, nf,
            T12, **r)
        fh = [sim.features_on(p, "cpu") for p in pair]
        fc = [sim.features_on(p, "cuda") for p in pair]
        rh = [cameras.unproject(kb8, host["cam"], f.uv) for f in fh]
        rc = [cameras.unproject(kb8, card["cam"], f.uv) for f in fc]
        tri = {}
        for exact in (True, False):
            xh = cameras.triangulate(rh[0], rh[1], host["R21"], host["t21"],
                                     exact=exact)
            xc = cameras.triangulate(rh[0].cuda(), rh[1].cuda(), card["R21"],
                                     card["t21"], exact=exact)
            tri["exact" if exact else "library"] = _rows_differ(xh, xc)
        dh, okh = stereo.fisheye_stereo_match(
            fh[0], fh[1], host["cam"], host["cam"], host["R21"],
            host["t21"], *lap)
        dc, okc = stereo.fisheye_stereo_match(
            fc[0], fc[1], card["cam"], card["cam"], card["R21"],
            card["t21"], *lap)
        proj = [_rows_differ(fn(kb8, host["cam"], r), fn(
            kb8, card["cam"], r.cuda())) for fn in (cameras.project,
                                                    cameras.project_jac)
                for r in rh]
        print(f"frame {k}: KB8 projection of the host's rays differs in "
              f"{proj[0]} / {proj[1]} rows, its Jacobian in {proj[2]} / "
              f"{proj[3]} (atan2)", flush=True)
        print(f"frame {k}: rays differ left {_rows_differ(rh[0], rc[0])}, "
              f"right {_rows_differ(rh[1], rc[1])} of {len(rh[0])}; "
              f"triangulation of the host's rays differs in "
              f"{tri['exact']} rows (exact), {tri['library']} (library); "
              f"stereo match: accepted masks differ in "
              f"{int((okh != okc.cpu()).sum())}, depths in "
              f"{_rows_differ(dh[:, None], dc[:, None])}", flush=True)

    lie_sites()


def lie_sites():
    """Rows of 512 seeded tangents where each lie.py site of ROADMAP C15
    gives other bits on the card than on the host."""
    import torch

    from orb_slam_fusion_tpu_torch import lie
    g = torch.Generator().manual_seed(15)
    w = torch.randn(512, 3, generator=g)
    xi = torch.randn(512, 7, generator=g) * 0.5
    S = lie.sim3_exp(xi)
    sites = {
        "so3_exp (library sin, cos)": (lie.so3_exp, w),
        "so3_left_jacobian (library sin, cos)": (lie.so3_left_jacobian, w),
        "so3_right_jacobian_inv (libm sin, cos)": (
            lie.so3_right_jacobian_inv, w),
        "so3_log (libm atan2)": (lambda R: lie.so3_log(R),
                                 lie.so3_exp(w)),
        "sim3_exp (libm exp, sin, cos)": (
            lambda x: torch.cat([lie.sim3_exp(x).s[:, None],
                                 lie.sim3_exp(x).t], -1), xi),
        "sim3_log (libm log)": (lambda s: lie.sim3_log(lie.Sim3(
            s, S.R.to(s.device), S.t.to(s.device))), S.s),
    }
    for name, (fn, x) in sites.items():
        print(f"site {name}: card and host differ in "
              f"{_rows_differ(fn(x), fn(x.cuda()))} of {len(x)} rows",
              flush=True)


if __name__ == "__main__":
    main()
