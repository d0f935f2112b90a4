"""Leveled logging singleton (a copy of the reference's
``orb_slam_fusion_tpu/utils/verbose.py``; reference: Verbose,
include/system.h:47-65)."""

from __future__ import annotations

import sys


class Verbose:
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    DEBUG = 3

    _level = 1

    @classmethod
    def set_level(cls, level: int) -> None:
        cls._level = level

    @classmethod
    def log(cls, msg: str, level: int = 1) -> None:
        if level <= cls._level:
            print(f"[osf] {msg}", file=sys.stderr)
