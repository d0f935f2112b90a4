"""The far fisheye point of ``test_torch_stereo.py::
test_fisheye_stereo_match_on_rendered_pairs[0]``, step by step (ROADMAP
C14a)::

    JAX_PLATFORMS=cpu python tests/torch_triangulate_probe.py \\
        [--dump DIR] [--write-golden]

Frame 0 of the rendered KB8 pair, built as the test builds it, goes
through both packages' own ``fisheye_stereo_match``; each package's
``cameras.triangulate`` is wrapped to record the rays it is given. Then,
on the reference's rays: both packages' ``triangulate_midpoint``, and
``triangulate_refine`` with ``iters`` = 1, 2, 3 from the reference's
midpoint (the reference's own argument), for the port's polish in the
reference's rounding and for its library polish (``exact=False``, the
mapping step's). Printed: whether the rays agree, and per step how many
of the accepted points and which of all rows differ, with the far point's
depth (the accepted point the library polish moves most).

``--dump DIR`` (a directory outside the repository) has XLA:CPU write its
compiled programs there and reads the Gauss-Newton loop's body off them:
its dots in program order (``R21 X``, ``J2p R21``, ``J^T J``, ``J^T r``)
with their shapes and each kernel's float instructions (``vfmadd``: fused;
``vmul``/``vadd``: rounded apart), and the LAPACK calls of the solve.
Needs ``objdump``.

``--write-golden`` writes ``tests/torch_goldens/
fisheye_triangulation_frame0.npz``: the port's rays of the case, the rig,
and the port's triangulation of them on the host, which ``chip_smoke.py``
holds the card to bit for bit. A few seconds.
"""

import argparse
import glob
import os
import re
import subprocess
import sys

import numpy as np

GOLDEN = "fisheye_triangulation_frame0.npz"


def _record(module):
    """Wrap ``module.triangulate`` to keep its arguments; returns the list
    the calls land in and a function that restores it."""
    calls, fn = [], module.triangulate

    def rec(*a, **k):
        calls.append([np.array(x) if not hasattr(x, "numpy")
                      else x.numpy().copy() for x in a])
        return fn(*a, **k)

    module.triangulate = rec
    return calls, lambda: setattr(module, "triangulate", fn)


def case_rays():
    """Both packages' triangulation arguments and accepted masks on frame
    0 of the test's rendered pair."""
    import jax.numpy as jnp
    import torch

    import test_torch_helpers as h
    from test_torch_stereo import KB8, RENDER, T_C1_C2
    from orb_slam_fusion_tpu import cameras as jcam
    from orb_slam_fusion_tpu.frontend import stereo as jst
    from orb_slam_fusion_tpu_torch import cameras as tcam
    from orb_slam_fusion_tpu_torch import sim as tsim
    from orb_slam_fusion_tpu_torch.frontend import stereo as tst
    from orb_slam_fusion_tpu_torch.map import convert

    wt = tsim.make_corridor_world(n_frames=1, n_points=6000, seed=11)
    fL, fR = tsim.render_fisheye_stereo_frame_numpy(
        wt, 0, KB8, KB8, (512, 512), 512, T_C1_C2, seed=17, **RENDER)
    T21 = np.linalg.inv(T_C1_C2)
    R21, t21 = T21[:3, :3].astype(np.float32), T21[:3, 3].astype(np.float32)
    lap = ((0.0, 512.0), (0.0, 512.0))
    jcalls, undo = _record(jcam)
    try:
        jd, jok = jst.fisheye_stereo_match(
            h.jax_features(fL), h.jax_features(fR), jnp.asarray(KB8),
            jnp.asarray(KB8), jnp.asarray(R21), jnp.asarray(t21), *lap)
    finally:
        undo()
    tcalls, undo = _record(tcam)
    try:
        td, tok = tst.fisheye_stereo_match(
            convert.features_from_numpy(fL, "cpu"),
            convert.features_from_numpy(fR, "cpu"),
            torch.tensor(KB8, dtype=torch.float32),
            torch.tensor(KB8, dtype=torch.float32), torch.from_numpy(R21),
            torch.from_numpy(t21), *lap)
    finally:
        undo()
    return dict(ref=jcalls[0], port=tcalls[0],
                ok=np.asarray(jok) & tok.numpy(),
                depth_ref=np.asarray(jd), depth_port=td.numpy())


def _differ(a, b):
    """Rows where two (N, 3) float arrays differ in any bit (NaN = NaN)."""
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                      & np.isnan(b))
    return ~same.all(-1)


def steps(c):
    """Per Gauss-Newton step from the reference's midpoint: the
    reference's points and the port's, exact and library."""
    import jax.numpy as jnp
    import torch

    from orb_slam_fusion_tpu import cameras as jcam
    from orb_slam_fusion_tpu_torch import cameras as tcam

    J = [jnp.asarray(a) for a in c["ref"]]
    T = [torch.from_numpy(a) for a in c["ref"]]
    X0 = np.asarray(jcam.triangulate_midpoint(*J))
    out = dict(mid_ref=X0,
               mid_port=tcam.triangulate_midpoint(*T).numpy())
    for it in (1, 2, 3):
        out[f"ref{it}"] = np.asarray(jcam.triangulate_refine(
            jnp.asarray(X0), *J, iters=it))
        out[f"exact{it}"] = tcam.triangulate_refine(
            torch.from_numpy(X0), *T, iters=it).numpy()
        out[f"library{it}"] = tcam._refine_library(
            torch.from_numpy(X0), *T, iters=it).numpy()
    return out


def read_dump(d):
    """The Gauss-Newton loop body's dots and LAPACK calls from XLA:CPU's
    dump in ``d``: [(name, shape, operands, fma, mul, add)], [targets]."""
    hlo = [f for f in glob.glob(os.path.join(d, "*cpu_after_optimizations"
                                                ".txt"))
           if "lapack_sgetrf" in open(f).read()]
    if not hlo:
        raise RuntimeError(f"no compiled loop with a LAPACK solve in {d}")
    text = open(hlo[0]).read()
    prefix = hlo[0][:-len("cpu_after_optimizations.txt")]
    dots, calls = [], []
    for line in text.splitlines():
        m = re.match(r"\s*%(dot_general\.\d+) = (\S+) dot\((.*?)\),", line)
        if m:
            obj = f"{prefix}obj-file.{m.group(1)}_elemental_kernel_module.o"
            asm = subprocess.run(["objdump", "-d", "--no-show-raw-insn", obj],
                                 capture_output=True, text=True).stdout
            dots.append((m.group(1), m.group(2), m.group(3),
                         len(re.findall(r"\svfn?madd\w*", asm)),
                         len(re.findall(r"\svmul[sp]s", asm)),
                         len(re.findall(r"\svadd[sp]s", asm))))
        m = re.search(r'custom_call_target="(lapack_\w+)"', line)
        if m:
            calls.append(m.group(1))
    return dots, calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", help="XLA dump directory (outside the repo)")
    ap.add_argument("--write-golden", action="store_true")
    a = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    if a.dump:
        flags += f" --xla_dump_to={a.dump} --xla_dump_hlo_as_text"
    os.environ["XLA_FLAGS"] = flags.strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    import torch
    torch.set_num_threads(2)

    c = case_rays()
    ok = c["ok"]
    print(f"accepted by both packages: {int(ok.sum())} of {ok.size}")
    for i, side in enumerate(("left", "right")):
        print(f"{side} rays, rows where the packages differ: "
              f"{int(_differ(c['ref'][i], c['port'][i]).sum())}")
    s = steps(c)
    far = int(np.argmax(np.where(ok, np.abs(s["library3"][:, 2]
                                            / s["ref3"][:, 2] - 1), -1)))
    print(f"far point: row {far}, rays equal: "
          f"{not _differ(c['ref'][0], c['port'][0])[far]} and "
          f"{not _differ(c['ref'][1], c['port'][1])[far]}")
    print(f"midpoint: rows differing {int(_differ(s['mid_ref'], s['mid_port']).sum())}, "
          f"far point depth {s['mid_ref'][far, 2]!r} (port "
          f"{s['mid_port'][far, 2]!r})")
    for it in (1, 2, 3):
        for kind in ("exact", "library"):
            d = _differ(s[f"ref{it}"], s[f"{kind}{it}"])
            print(f"step {it} {kind:7s}: rows differing {int(d.sum())} "
                  f"(accepted {int((d & ok).sum())}); far point depth "
                  f"{s[f'{kind}{it}'][far, 2]!r}, the reference's "
                  f"{s[f'ref{it}'][far, 2]!r}")
    print(f"fisheye_stereo_match depth of the far point: reference "
          f"{c['depth_ref'][far]!r}, port {c['depth_port'][far]!r}")
    if a.dump:
        dots, calls = read_dump(a.dump)
        print("the loop body's dots in program order (fused multiply-adds, "
              "multiplies, adds in the kernel):")
        for name, shape, ops, f, m, ad in dots:
            print(f"  {name} {shape} dot({ops}): {f} fma, {m} mul, {ad} add")
        print("its LAPACK calls: " + ", ".join(calls))
    if a.write_golden:
        from orb_slam_fusion_tpu_torch import cameras as tcam
        T = [torch.from_numpy(x) for x in c["port"]]
        X = tcam.triangulate(*T).numpy()
        path = os.path.join(here, "torch_goldens", GOLDEN)
        np.savez_compressed(path, ray1=c["port"][0], ray2=c["port"][1],
                            R21=c["port"][2], t21=c["port"][3], X=X,
                            accepted=ok, far=np.int32(far))
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
