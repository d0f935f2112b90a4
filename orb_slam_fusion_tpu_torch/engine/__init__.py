"""SLAM engine: the per-frame tracking step, the per-keyframe mapping step
and the sessions around them (monocular, stereo family, inertial)."""

from .config import SlamConfig  # noqa: F401
from .tracker import MonoTracker, TrackState  # noqa: F401
from .vio_tracker import (FisheyeStereoVioTracker,  # noqa: F401
                          StereoVioTracker, VioTracker)
