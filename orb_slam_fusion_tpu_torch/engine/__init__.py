"""SLAM engine: the per-frame tracking step, the per-keyframe mapping step
and the monocular session around them."""

from .config import SlamConfig  # noqa: F401
from .tracker import MonoTracker, TrackState  # noqa: F401
