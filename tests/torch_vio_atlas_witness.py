#!/usr/bin/env python3
"""The main path's session frame by frame, beside its golden, the JAX
package and itself.

    python tests/torch_vio_atlas_witness.py [--device cpu|cuda] [--frames N]
        [--threads T] [--repeat R] [--deterministic] [--out FILE]
    JAX_PLATFORMS=cpu python tests/torch_vio_atlas_witness.py --jax [...]

Runs ``chip_smoke.py``'s stereo-inertial atlas session
(``chip_smoke.vio_atlas_session``: ``StereoVioTracker(SlamConfig(), 0.11,
make_calib())`` on ``test_inertial_merge.py``'s circle, blackout 58-67)
with the port on the given device, for the first N of its 140 frames. Per
frame it prints the state, inliers, keyframes, map points, archived maps
and loops closed beside the golden's
(``tests/torch_goldens/stereo_vio_atlas_session_480x752.json``), and a
SHA-256 of the keyframe poses and map points.

``--jax`` also steps the JAX package's tracker (on the CPU) on the same
inputs in lockstep, and prints per frame the largest difference between
the two trackers' keyframe poses and map points while their tables hold
the same rows. ``--repeat R`` runs the port's session R times and names
the first frame on which a run's digest differs from the first run's;
``--deterministic`` turns on ``torch.use_deterministic_algorithms``
(warning only) first, and the summary names the ops that warned that
they have no deterministic implementation. Ends with one JSON summary
line (also written to ``--out``).
The port's modes import no JAX.
"""

import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

GOLDEN = "stereo_vio_atlas_session_480x752.json"
COUNTS = ("state", "inliers", "n_kf", "n_mp", "archived", "closed")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _tables(tr):
    """(keyframe rotations, translations, map points) of the live rows."""
    m = tr.map
    K, M = int(m.n_kf), int(m.n_mp)
    return (_host(m.kf_pose.R)[:K], _host(m.kf_pose.t)[:K],
            _host(m.mp_pos)[:M])


def _digest(tables) -> str:
    h = hashlib.sha256()
    for a in tables:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _row(tr, rec):
    lc = tr.loop_closer
    return dict(state=rec.state, inliers=int(rec.tracked),
                n_kf=int(tr.map.n_kf), n_mp=int(tr.map.n_mp),
                archived=len(tr.atlas), closed=int(lc.num_closed),
                imu_stage=int(tr._imu_stage))


class _Reference:
    """The JAX package's tracker on the same inputs (CPU)."""

    def __init__(self):
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_threefry_partitionable", True)
        from orb_slam_fusion_tpu.engine import SlamConfig
        from orb_slam_fusion_tpu.engine.vio_tracker import StereoVioTracker
        from orb_slam_fusion_tpu.imu.preintegration import make_calib
        self.tr = StereoVioTracker(SlamConfig(), chip_smoke.VIO_BASELINE,
                                   make_calib())
        self.tr.reloc_grace_frames = chip_smoke.ATLAS_GRACE

    def step(self, pair, imu, ts):
        import jax.numpy as jnp
        from orb_slam_fusion_tpu.frontend.extractor import Features
        fL, fR = (Features(**{n: jnp.asarray(a[n]) for n in Features._fields})
                  for a in pair)
        return self.tr.process_stereo_imu(fL, fR, ts, *imu)


def run(dev, frames, golden, reference=None):
    """One session; returns the per-frame rows."""
    tracker, _, make, step = chip_smoke.vio_atlas_session(dev)
    rows = []
    for k in range(frames):
        inputs, ts, digest = make(k)
        g = golden["frames"][k]
        if digest != g["inputs_sha256"]:
            raise RuntimeError(f"frame {k}: other inputs than the golden's")
        t0 = time.perf_counter()
        row = _row(tracker, step(inputs, ts))
        row.update(frame=k, ms=(time.perf_counter() - t0) * 1e3)
        tabs = _tables(tracker)
        row["digest"] = _digest(tabs)
        row["golden"] = [g["tracked" if n == "inliers" else n]
                         for n in COUNTS]
        if reference is not None:
            pair, imu, ts_ = make.numpy(k)
            ref = _row(reference.tr, reference.step(pair, imu, ts_))
            row["reference"] = [ref[n] for n in COUNTS]
            jt = _tables(reference.tr)
            if all(a.shape == b.shape for a, b in zip(tabs, jt)):
                row["max_diff"] = [float(np.abs(a - b).max(initial=0.0))
                                   for a, b in zip(tabs, jt)]
        print("frame " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _first(rows, want):
    """The first frame whose counts differ from ``want(row)``."""
    return next((r["frame"] for r in rows
                 if [r[n] for n in COUNTS] != want(r)), None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--frames", type=int, default=140)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if a.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import warnings
    torch.set_num_threads(a.threads)
    if a.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(a.device)
    golden = chip_smoke._golden(GOLDEN)
    runs = []
    with warnings.catch_warnings(record=True) as notes:
        warnings.simplefilter("always")
        for i in range(a.repeat):
            ref = _Reference() if a.jax and i == 0 else None
            runs.append(run(dev, a.frames, golden, ref))
    first = runs[0]
    last = first[-1]
    summary = dict(
        device=str(dev), torch=torch.__version__, frames=a.frames,
        deterministic=a.deterministic, final=[
            {n: r[-1][n] for n in ("n_kf", "n_mp", "archived", "closed")}
            for r in runs],
        golden_final=last["golden"],
        first_frame_differing_from_golden=_first(
            first, lambda r: r["golden"]),
        archive_merge_frames=chip_smoke._loop_events(first),
        first_frame_differing_from_run_1=[
            next((x["frame"] for x, y in zip(r, first)
                  if x["digest"] != y["digest"]), None) for r in runs[1:]])
    if a.jax:
        summary["first_frame_differing_from_reference"] = _first(
            first, lambda r: r["reference"])
        summary["max_diff_by_frame"] = [r.get("max_diff") for r in first]
    # the ops that warned that they have no deterministic implementation
    summary["nondeterministic_ops"] = sorted({
        str(w.message).split(" does not have")[0] for w in notes
        if "deterministic" in str(w.message)})
    if a.device.startswith("cuda"):
        summary["card"] = chip_smoke._card_line()
    line = json.dumps(summary)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
