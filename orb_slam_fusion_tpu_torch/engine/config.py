"""Engine configuration.

Counterpart of ``orb_slam_fusion_tpu/engine/config.py``: the same fields
and defaults, so a configuration written for the reference reads the same
here, ``SlamConfig()`` as is (loop closing on) included.
``mesh_devices > 0`` runs tracking, local BA and the loop closer's global
BA on a mesh (``parallel/``, see ``engine/tracker.py``); ``cam_model`` is
``"pinhole"`` or ``"kannala_brandt8"``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from .. import cameras
from ..frontend.extractor import OrbParams


class SlamConfig(NamedTuple):
    # camera
    cam_model: str = cameras.PINHOLE
    cam_params: Tuple[float, ...] = (458.654, 457.296, 367.215, 248.375)
    # radial-tangential (k1,k2,p1,p2) for unrectified pinhole inputs; empty
    # or all-zero -> no undistortion
    distortion: Tuple[float, ...] = ()
    image_size: Tuple[int, int] = (480, 752)      # (H, W)
    fps: float = 20.0

    # features
    orb: OrbParams = OrbParams(n_features=1024)

    # capacities (static shapes)
    max_keyframes: int = 256
    max_map_points: int = 8192

    # tracking policy (reference: tracking.cc NeedNewKeyFrame / matchers)
    match_radius_coarse: float = 15.0
    match_radius_fine: float = 9.0
    min_track_matches: int = 20
    kf_tracked_ratio: float = 0.9
    kf_max_interval: int = 10
    kf_min_interval: int = 1

    # far-point threshold in metres; 0 = unlimited
    th_far_points: float = 0.0

    # mapping policy
    ba_window: int = 8
    ba_fixed_ring: int = 4
    ba_iters_first: int = 5
    ba_iters_second: int = 10
    min_parallax_deg: float = 1.0
    culling_found_ratio: float = 0.25
    tri_covisible: int = 3

    # initialization
    init_min_matches: int = 80
    init_min_inliers: int = 50

    # loop closing
    loop_closing: bool = True
    vocab_words: int = 4096
    vocab_path: str = ""
    loop_consistency_th: int = 3
    loop_proj_matches: int = 50
    loop_proj_matches_ref: int = 80

    # background (chunked) execution of local BA / global BA
    background_lba: bool = True
    background_gba: bool = True

    # distributed execution: 0 = single device; N > 0 routes tracking
    # through the map-sharded mesh program (parallel/dist_track.py), and
    # local BA and the loop closer's GBA through the landmark-sharded Schur
    # reduction (parallel/dist_ba.py), over min(N, CUDA devices) cards or,
    # on the CPU, N shards of it
    mesh_devices: int = 0
