"""An earlier commit's solvers and this tree's in turns on the card::

    python tests/torch_solver_turns.py --parent DIR [--order pccp]

DIR holds an unpacked earlier commit of the repository (``git archive``
into a git-ignored directory). Each turn runs in its own process, from the
root of its tree: ``chip_smoke.check_viba1_solvers`` (the VIBA1 keyframe's
``inertial_init`` and full VI-BA: launches, device-busy and wall ms),
``check_pcg_linearization`` (one PCG step) and ``run_global_ba`` (the K =
512 PCG global BA), after building that tree's kernels. ``--order`` gives
the turns, ``p`` the parent and ``c`` this tree (default parent, change,
change, parent). Prints the card's name and power limit, then one ``SIDE``
JSON line per turn. Needs a CUDA device; imports no JAX.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN = r'''
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from orb_slam_fusion_tpu_torch.kernels import build
build.build_all()
dev = torch.device("cuda")
out = dict(viba1=cs.check_viba1_solvers(dev),
           pcg=cs.check_pcg_linearization(dev), gba=cs.run_global_ba(dev))
print("SIDE " + json.dumps(dict(side={side!r}, **out)), flush=True)
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--order", default="pccp")
    a = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for turn in a.order:
        side, root = (("parent", os.path.abspath(a.parent)) if turn == "p"
                      else ("change", ROOT))
        r = subprocess.run([sys.executable, "-c",
                            TURN.format(root=root, side=side)], cwd=root,
                           capture_output=True, text=True, timeout=900)
        print("\n".join(line for line in r.stdout.splitlines()
                        if line.startswith("SIDE")), flush=True)
        if r.returncode:
            sys.exit(f"{side} turn failed:\n{r.stderr[-4000:]}")


if __name__ == "__main__":
    main()
