"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` exports plain ``extern "C"`` launchers. At first use
every source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` into a shared library with a C interface, under
``orb_slam_fusion_tpu_torch/_build/<hash>/`` (git-ignored), with
``NVCC_FLAGS`` and the source's own ``EXTRA_FLAGS``. The hash covers
the sources and the flags, so an edited kernel rebuilds and an unchanged
one is reused. Nothing here includes PyTorch's headers: a build takes
seconds, not the minutes ``torch.utils.cpp_extension`` needs. ``BUILD_LOG``
keeps nvcc's output (ptxas's register and shared-memory report).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# flags of one source on top of NVCC_FLAGS: libm.cu restates the
# reference's roundings step by step, so nvcc may fuse nothing
EXTRA_FLAGS = {"libm": ("-fmad=false",)}

# launcher name -> ctypes argtypes (pointers and the stream as c_void_p)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "masked_match": ("osf_masked_match",
                     [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
    "libm": ("osf_libm", [_I, _P, _P, _P, _P, _L, _I, _P, _P]),
}


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / _digest(name) / f"lib{name}.so"


def build_all(names=None) -> Dict[str, float]:
    """Compile every kernel source that has no up-to-date library, one nvcc
    per source, all running at once. Returns seconds per built source."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _target(n)
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc, *_flags(n), "-o", tmp, str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    secs, errors = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):"
                          f"\n{log}")
        else:
            os.replace(tmp, out)       # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launcher(name: str):
    """The ``extern "C"`` launcher of kernel ``name`` with argtypes set."""
    return getattr(load(name), SIGNATURES[name][0])
