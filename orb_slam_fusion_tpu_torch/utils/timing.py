"""Per-stage timing instrumentation.

Counterpart of ``orb_slam_fusion_tpu/utils/timing.py`` with the same stage
names (``orb_extract``, ``initialize``, ``track_frame``,
``keyframe_insert``, ``local_ba``) and counters. Disabled (the default),
``stage()`` does nothing and adds no device synchronisation. Enabled, it
synchronises the CUDA device before reading the clock at both ends, so a
stage's time includes the device work it queued.

Usage:
    from orb_slam_fusion_tpu_torch.utils.timing import STAGES, stage
    STAGES.enable()
    with stage("track_frame"):
        ...
    print(STAGES.report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class StageStats:
    def __init__(self):
        self.enabled = False
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()
        self.counters.clear()

    def add(self, name: str, seconds: float) -> None:
        self.total[name] += seconds
        self.count[name] += 1

    def bump(self, name: str, n: int = 1) -> None:
        """Event counters (reference: num_FixedKF_BA / num_MPs_BA etc.)."""
        if self.enabled:
            self.counters[name] += n

    def report(self) -> str:
        lines = ["stage                  calls   total(s)   mean(ms)"]
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            c = self.count[name]
            t = self.total[name]
            lines.append(f"{name:<22} {c:>5}   {t:>8.3f}   {t/c*1000:>8.2f}")
        for name in sorted(self.counters):
            lines.append(f"{name:<22} {self.counters[name]:>5}")
        return "\n".join(lines)


STAGES = StageStats()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name: str):
    if not STAGES.enabled:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        STAGES.add(name, time.perf_counter() - t0)
