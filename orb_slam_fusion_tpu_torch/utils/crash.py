"""Crash dumps: the reference's Breakpad-minidump role, Python-native.

Counterpart of ``orb_slam_fusion_tpu/utils/crash.py``. The reference's
EuRoC runner installs a Google Breakpad handler that writes a minidump on
any crash (tests/slam_euroc_si.cc:38-57). Here:

* ``faulthandler`` armed on SIGSEGV/SIGABRT/etc. writing native tracebacks
  to a dump file (covers crashes inside CUDA or native extensions);
* a ``sys.excepthook`` chain that serializes the Python traceback plus a
  one-line engine snapshot (frame id, keyframe/point counts, state).

Enable via ``install_crash_handler()`` (the System facade does this when
``crash_dir`` is configured).
"""

from __future__ import annotations

import datetime
import faulthandler
import io
import os
import sys
import tempfile
import traceback
from typing import Callable, Optional

_state_probe: Optional[Callable[[], str]] = None
_dump_dir: Optional[str] = None
_fault_file = None
_prev_hook = None


def set_state_probe(fn: Callable[[], str]) -> None:
    """Register a callable returning a one-line engine snapshot for dumps."""
    global _state_probe
    _state_probe = fn


def _dump_path(kind: str) -> str:
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    return os.path.join(_dump_dir, f"osf-crash-{stamp}-{kind}.txt")


def _excepthook(exc_type, exc, tb):
    try:
        buf = io.StringIO()
        buf.write("orb_slam_fusion_tpu_torch crash dump\n")
        buf.write(f"time: {datetime.datetime.now().isoformat()}\n")
        if _state_probe is not None:
            try:
                buf.write(f"engine: {_state_probe()}\n")
            except Exception as probe_err:  # the probe must never mask
                buf.write(f"engine: <probe failed: {probe_err!r}>\n")
        buf.write("".join(traceback.format_exception(exc_type, exc, tb)))
        with open(_dump_path("py"), "w") as f:
            f.write(buf.getvalue())
    except Exception:
        pass
    if _prev_hook is not None:
        _prev_hook(exc_type, exc, tb)


def install_crash_handler(dump_dir: Optional[str] = None) -> str:
    """Arm fault + exception dumping. Returns the dump directory (by
    default ``osf_dumps`` under the temporary directory)."""
    global _dump_dir, _fault_file, _prev_hook
    if dump_dir is None:
        dump_dir = os.path.join(tempfile.gettempdir(), "osf_dumps")
    os.makedirs(dump_dir, exist_ok=True)
    _dump_dir = dump_dir
    if _fault_file is None:
        _fault_file = open(os.path.join(dump_dir, "osf-faults.txt"), "a")
        faulthandler.enable(file=_fault_file, all_threads=True)
    if _prev_hook is None:
        _prev_hook = sys.excepthook
        sys.excepthook = _excepthook
    return dump_dir


def uninstall_crash_handler() -> None:
    global _dump_dir, _fault_file, _prev_hook
    if _prev_hook is not None:
        sys.excepthook = _prev_hook
        _prev_hook = None
    if _fault_file is not None:
        faulthandler.disable()
        _fault_file.close()
        _fault_file = None
    _dump_dir = None
