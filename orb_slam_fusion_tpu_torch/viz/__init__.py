"""Visualization: headless map / frame drawing (matplotlib, imported only
when drawing) and the self-contained interactive HTML viewer.

Counterpart of ``orb_slam_fusion_tpu/viz/``: the reference's Pangolin
viewer stack (src/viewer.cc, src/utils/{map_drawer,frame_drawer}.cc)
becomes PNG rendering (``drawers.py``) and an offline HTML viewer with the
reference viewer's menu (``viewer.py``).
"""

from .drawers import FrameDrawer, MapDrawer, draw_frame, draw_map  # noqa: F401
from .viewer import export_interactive  # noqa: F401
