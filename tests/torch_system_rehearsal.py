#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s ``system_session`` phase on the host CPU.

    python tests/torch_system_rehearsal.py [--threads N] [--no-feature-check]

Runs ``chip_smoke.run_system_session`` with the port on the CPU (numpy and
the port only, no JAX): CUDA synchronization and the kernel timing are
stubbed, and the masked match's plain version is counted as a launch, so
the phase's launch gates hold. Its gates against the golden are opened
and reported instead: the line ``first frame differing`` names the first
frame whose state, inliers, keyframes, map points or IMU stage differ
from the golden's, which is what ``chip_smoke.SYSTEM_EXACT_FRAMES`` is
set from; then one line per frame, port beside golden. About 8-15 s a
frame at 1200 features; ``--no-feature-check`` skips the three frames'
card-against-CPU feature check, which on the CPU compares the CPU with
itself.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam_fusion_tpu_torch.frontend import masked_match as mm  # noqa

KEYS = ("state", "tracked", "n_kf", "n_mp", "imu_stage")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--no-feature-check", action="store_true")
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    torch.cuda.synchronize = lambda *args, **kw: None
    plain = mm.masked_match_plain

    def counted(*args, **kw):
        mm.launches += 1
        return plain(*args, **kw)
    mm.masked_match_plain = counted
    cs._session_calls = lambda label, tracker, feats: []
    cs.profile_stages = lambda stages, **kw: {
        name: {} for name in stages}
    if a.no_feature_check:
        def first_features(sys_, raw, k, orb):
            from orb_slam_fusion_tpu_torch.frontend.extractor import (
                extract_features)
            img = sys_._rectify(*(sys_._preprocess(x) for x in raw))[0]
            return extract_features(img, orb)
        cs._system_features_check = first_features

    def report(out, golden, rows):
        first = next((k for k, (r, g) in enumerate(zip(rows,
                                                       golden["frames"]))
                      if any(r[n] != g[n] for n in KEYS)), None)
        print(f"first frame differing in {KEYS}: {first}", flush=True)
        for k, (r, g) in enumerate(zip(rows, golden["frames"])):
            print(k, [r[n] for n in KEYS], [g[n] for n in KEYS], flush=True)
        print("loop stats", out["loop_stats"], "golden",
              out["golden_loop_stats"], flush=True)
    cs._system_gates = report
    t0 = time.time()
    cs.run_system_session(torch.device("cpu"))
    print(f"done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
