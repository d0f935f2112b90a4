"""The reference's own spread across library kernels, beside the port's
distance from it (ROADMAP C13).

Runs a parity case's reference side in child interpreters under each of
OpenBLAS's Haswell, SkylakeX and Cooperlake cores x XLA:CPU's host code
(AVX-512 here), ``--xla_cpu_max_isa=AVX2`` and ``=AVX``, and the port once
in the pinned regime (``torch_regime.PINNED``), then prints, per quantity,
the largest difference between two reference runs and the port's largest
difference from the pinned reference's::

    JAX_PLATFORMS=cpu python tests/torch_regime_spread.py \
        [CASE ...] [--rows] [--port-default] [--jobs 5]

``slice`` is ``test_torch_slice.py``'s loop (frames 2-3, past the first
local BA), ``viba1`` the VIBA1 keyframe step of
``test_torch_vio_mono_session.py`` from one carried state (the pinned
regime's, pickled once), ``viba_seeded`` the LM candidates of
``test_torch_vi_ba.py``'s seeded monocular VI-BA, ``chunked`` the
ChunkedLM window of ``test_torch_capacity.py`` and ``atlas_init`` the
first four frames of ``chip_smoke.py``'s atlas session (ROADMAP C12).
``--rows`` prints each run's values; ``--port-default`` runs the port in
the parent's regime (MKL's default branch) instead of the pinned one. A
few minutes each; the SkylakeX and Cooperlake cores need AVX-512.
"""

import argparse
import concurrent.futures
import os
import pickle
import sys
import tempfile

import numpy as np

from torch_regime import PINNED, call_in_regime

CORES = ("Haswell", "SkylakeX", "Cooperlake")
ISAS = ("", "AVX2", "AVX")            # "" = XLA:CPU's code for the host


def regimes():
    for core in CORES:
        for isa in ISAS:
            env = dict(PINNED, OPENBLAS_CORETYPE=core)
            if isa:
                env["XLA_FLAGS"] = f"--xla_cpu_max_isa={isa}"
            yield f"{core}/{isa or 'host'}", env


# --- the cases: each returns {quantity: array} for one package -------------


def slice_case(package):
    import test_torch_slice as m

    img, fields = m._world()
    log = (m._run_jax if package == "reference" else m._run_port)(img,
                                                                  fields)
    out = {}
    for i in range(m.CARRY_AFTER + 1, m.FRAMES):
        e = log[i]
        out[f"frame {i} counts"] = np.asarray(e["counts"], np.int64)
        out[f"frame {i} t"] = np.asarray(e["t"])
        out[f"frame {i} R"] = np.asarray(e["R"])
        if "stats" in e:
            out[f"frame {i} stats"] = np.asarray(e["stats"], np.int64)
            out[f"frame {i} edges"] = np.asarray([e["edges"]], np.int64)
            out[f"frame {i} first candidate"] = np.asarray(e["costs"][:1])
    return out


def viba1_snapshot(path):
    """Run the reference to the VIBA1 keyframe and pickle its state."""
    import test_torch_vio_mono_session as m
    import torch_vio_cases as cases
    from orb_slam_fusion_tpu.engine.vio_tracker import VioTracker as JVio

    step_ref, _ = _vio_steps(m)
    jt = JVio(m.JConfig(orb=m.JOrb(n_features=512), **m.KW), m.j_calib())
    found = cases.checkpoints(jt, step_ref, m.SEQ["n_frames"])
    with open(path, "wb") as f:
        pickle.dump(found["viba1_keyframe"], f)


def _vio_steps(m):
    import jax.numpy as jnp

    import torch_vio_cases as cases

    jseq = m.jsim.make_vio_sequence(**m.SEQ)
    tseq = m.tsim.make_vio_sequence(**m.SEQ)
    cam = jnp.asarray(m.KW["cam_params"])

    def step_ref(tr, k):
        f = m.jsim.render_frame(jseq.world, k, cam, m.KW["image_size"], 512,
                                **m.RENDER)
        return tr.process_frame_imu(f, float(jseq.world.timestamps[k]),
                                    *cases.imu_of(jseq, k))

    def step_port(tr, k):
        f = m.tsim.render_frame(tseq.world, k, m.KW["cam_params"],
                                m.KW["image_size"], 512, device="cpu",
                                **m.RENDER)
        return tr.process_frame_imu(f, float(tseq.world.timestamps[k]),
                                    *cases.imu_of(tseq, k))

    return step_ref, step_port


def viba1_case(package, path):
    import test_torch_helpers as h
    import test_torch_vio_mono_session as m
    import torch_vio_cases as cases
    from orb_slam_fusion_tpu_torch.map import convert

    with open(path, "rb") as f:
        k, tr = pickle.load(f)
    step_ref, step_port = _vio_steps(m)
    out = {}

    def go():
        nonlocal tr
        if package == "reference":
            step_ref(tr, k)
            kf = h.jax_map_to_numpy(tr.map)["kf_pose"][1]
        else:
            port = m.VioTracker(
                m.SlamConfig(orb=m.OrbParams(n_features=512), **m.KW),
                m.make_calib(device="cpu"), device="cpu")
            convert.tracker_state_from_numpy(port, h.jax_tracker_state(tr))
            step_port(port, k)
            tr = port
            kf = convert.map_state_to_numpy(tr.map)["kf_pose"][1]
        out.update({"pose R": np.asarray(tr.cur_pose.R),
                    "pose t": np.asarray(tr.cur_pose.t),
                    "velocity": np.asarray(tr.cur_vel),
                    "gyro bias": np.asarray(tr.bias.gyro),
                    "acc bias": np.asarray(tr.bias.acc),
                    "keyframe positions": np.asarray(kf)})

    cases.with_threads(m.THREADS, go)
    return out


def viba_seeded_case(package):
    """``test_torch_vi_ba.py``'s seeded monocular VI-BA (forward): every LM
    candidate's cost and the final positions."""
    import jax.numpy as jnp
    import torch

    import test_torch_vi_ba as m

    d = m.vp.seeded(4, False)
    jf, tf, jc, tc = m._ifacs(d)
    jprob, tprob = m._problems(d, False)
    js, ts = m._states(d)
    if package == "reference":
        f = jnp.asarray(d["fixed"])
        r = m.jvi.visual_inertial_ba(js, jprob, jf, jc, fixed_pose=f,
                                     fixed_inertial=f, iters=10)
    else:
        f = torch.from_numpy(d["fixed"])
        r = m.tvi.visual_inertial_ba(ts, tprob, tf, tc, fixed_pose=f,
                                     fixed_inertial=f, iters=10)
    return {"candidate costs": np.asarray(r[2]),
            "positions": np.asarray(r[0].poses.t)}


def chunked_case(package):
    import test_torch_regime as m

    out = {}
    for i, e in enumerate(m.chunked_lm_run(package)):
        for key in ("R", "t", "points"):
            out[f"chunk {i} {key}"] = e[key]
        out[f"chunk {i} cost"] = np.asarray([e["cost"]])
    return out


def atlas_init_case(package, frames=4):
    """ROADMAP C12: ``chip_smoke.py``'s atlas session (``SlamConfig()``)
    over its first frames, monocular init included: per frame the state's
    code, tracked count, keyframes and map points."""
    import jax.numpy as jnp

    import chip_smoke as cs

    codes = {"init-ref": 0, "init-fail": 1, "init-no-match": 2,
             "init-done": 3, "ok": 4, "lost": 5}
    if package == "reference":
        from orb_slam_fusion_tpu import sim
        from orb_slam_fusion_tpu.engine import MonoTracker, SlamConfig

        cfg = SlamConfig()
        world = sim.make_corridor_world(**cs.ATLAS_WORLD)
        tr = MonoTracker(cfg)

        def feats(k):
            return (sim.render_frame(world, k, jnp.asarray(cfg.cam_params),
                                     cfg.image_size, cfg.orb.n_features,
                                     **cs.ATLAS_RENDER),
                    float(world.timestamps[k]))
    else:
        from orb_slam_fusion_tpu_torch import sim
        from orb_slam_fusion_tpu_torch.engine import MonoTracker, SlamConfig

        cfg = SlamConfig()
        world = sim.make_corridor_world(**cs.ATLAS_WORLD)
        tr = MonoTracker(cfg, device="cpu")
        make = cs._mono_loop_make(world, cfg, cs.ATLAS_RENDER,
                                  cs.ATLAS_BLACKOUTS, "cpu")

        def feats(k):
            return make(k)[:2]
    tr.reloc_grace_frames = cs.ATLAS_GRACE
    rows = []
    for k in range(frames):
        rec = tr.process_features(*feats(k))
        rows.append([codes.get(rec.state, -1), int(rec.tracked),
                     int(tr.map.n_kf), int(tr.map.n_mp)])
    return {"frames (state, tracked, keyframes, map points)":
            np.asarray(rows, np.int64)}


CASES = dict(slice=slice_case, viba1=viba1_case,
             viba_seeded=viba_seeded_case, chunked=chunked_case,
             atlas_init=atlas_init_case)


def _spread(runs):
    """{quantity: (largest pairwise difference, relative to the values)}."""
    out = {}
    for key in runs[0]:
        a = np.stack([r[key] for r in runs]).astype(np.float64)
        both = np.isfinite(a).all(0)
        d = np.where(both, np.ptp(np.where(both, a, 0), 0), 0)
        scale = np.abs(np.where(both, a, 0)).max(0)
        rel = np.where(scale > 0, d / np.where(scale > 0, scale, 1), 0)
        out[key] = (float(d.max()), float(rel.max()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", default=["slice", "viba1"],
                    choices=sorted(CASES))
    ap.add_argument("--jobs", type=int, default=5)
    ap.add_argument("--rows", action="store_true",
                    help="print every run's values, not only the spread")
    ap.add_argument("--port-default", action="store_true",
                    help="run the port in the parent's library regime "
                         "(MKL's default branch) instead of the pinned one")
    a = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        for case in a.cases:
            target = f"torch_regime_spread:{case}_case"
            args = ()
            if case == "viba1":
                args = (os.path.join(tmp, "viba1.pkl"),)
                call_in_regime("torch_regime_spread:viba1_snapshot", *args)
            with concurrent.futures.ThreadPoolExecutor(a.jobs) as pool:
                refs = {name: pool.submit(call_in_regime, target,
                                          "reference", *args, env=env)
                        for name, env in regimes()}
                port = pool.submit(call_in_regime, target, "port", *args,
                                   env={} if a.port_default else None)
                refs = {k: v.result() for k, v in refs.items()}
                port = port.result()
            pinned = refs[f"{PINNED['OPENBLAS_CORETYPE']}/host"]
            print(f"== {case}: the reference over {len(refs)} regimes "
                  f"({', '.join(refs)}); the port pinned", flush=True)
            if a.rows:
                for name, run in [*refs.items(), ("port", port)]:
                    for key, v in run.items():
                        print(f"  {name:16s} {key}: {v.tolist()}")
            spread = _spread(list(refs.values()))
            for key, (d, rel) in spread.items():
                p = _spread([pinned, port])[key]
                print(f"  {key:26s} reference spread {d:.4g} ({rel:.3g} "
                      f"rel)   port - pinned reference {p[0]:.4g} "
                      f"({p[1]:.3g} rel)", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
