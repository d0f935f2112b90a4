"""Multi-device paths: the mesh and the sharded solvers.

Counterpart of ``orb_slam_fusion_tpu/parallel/``: map-scale parallelism
over a one-controller mesh of torch devices (``mesh.SlamMesh``).
Landmarks (and their Schur blocks), map points or graph edges shard over
the mesh; the reduced systems are summed over the shards in rank order
and solved once, replicated. A mesh may repeat a device, so the 8-way
split runs on one card or on the CPU.
"""

from .dist_ba import distributed_bundle_adjustment, make_slam_mesh  # noqa: F401
from .dist_pose_graph import distributed_pose_graph  # noqa: F401
from .dist_vi_ba import distributed_visual_inertial_ba  # noqa: F401
from .dist_track import (  # noqa: F401
    DistFrameResult, distributed_frame_update, pad_map_for_mesh)
from .mesh import SlamMesh  # noqa: F401
