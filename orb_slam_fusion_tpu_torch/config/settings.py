"""Typed settings loader for the reference's YAML schema.

Counterpart of ``orb_slam_fusion_tpu/config/settings.py`` (reference:
src/config/settings.cc, include/config/settings.h:43-237): reads the same
``File.version: "1.0"`` layout (Camera1.* intrinsics, Camera.type
PinHole/KannalaBrandt8, Stereo.T_c1_c2, IMU.* noise and extrinsics,
ORBextractor.*) and the legacy no-version layout, so the reference's
EuRoC/TUM-VI/TUM RGB-D files drive the port unchanged. The file is parsed
by ``yaml_subset.py`` (no PyYAML: the GPU machine has none), which gives
the same mapping as the JAX package's PyYAML loader. Rectification maps
and rectified intrinsics come from ``frontend/rectify.py`` (host
float64); the IMU calibration is a port ``ImuCalib`` on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .. import resolve_device
from ..engine.config import SlamConfig
from ..frontend.extractor import OrbParams
from ..imu.preintegration import ImuCalib, make_calib
from .yaml_subset import parse_settings_yaml


@dataclasses.dataclass
class Settings:
    """Parsed settings: engine config + sensor calibration."""

    slam: SlamConfig
    calib: Optional[ImuCalib]          # None for vision-only configs
    baseline: float                    # stereo baseline (m), 0 for mono
    th_depth: float                    # close/far stereo threshold (x baseline)
    fps: float
    distortion: Tuple[float, ...]      # (k1,k2,p1,p2) radial-tangential
    load_atlas: Optional[str]
    save_atlas: Optional[str]
    # (mapL, mapR) per-pixel raw-image sampling coords for unrectified
    # pinhole stereo rigs (reference Settings::precomputeRectificationMaps,
    # settings.cc:521); None when input is already rectified
    rect_maps: Optional[Tuple[np.ndarray, np.ndarray]] = None
    rgb: bool = True                   # color order for 3-channel input
    # KB8 stereo rig (TUM-VI style, no rectification): right-camera
    # intrinsics, full extrinsic matrix, and per-camera stereo-overlap
    # ("lapping") column ranges (reference settings.cc:276-348)
    cam2_params: Optional[Tuple[float, ...]] = None
    T_c1_c2: Optional[np.ndarray] = None
    lapping: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = None
    # (H, W) to resize raw frames to before tracking (Camera.newWidth/
    # newHeight, settings.cc:375-436); None = feed as-is. Rectifying
    # configs resize through the maps instead.
    resize_to: Optional[Tuple[int, int]] = None
    th_far_points: float = 0.0         # System.thFarPoints (0 = unlimited)
    # raw depth-image value -> metres divisor (reference DepthMapFactor;
    # TUM RGB-D ships 5000.0)
    depth_map_factor: float = 1.0
    image_scale: float = 1.0           # resize factor vs raw input width


def _req(d, key):
    if key not in d:
        raise KeyError(f"required settings key missing: {key}")
    return d[key]


def load_settings(path: str, sensor: str = "mono", device=None
                  ) -> Settings:
    """sensor: mono | stereo | rgbd | mono-imu | stereo-imu (reference
    eSensor). The IMU calibration goes to ``device`` (CUDA unless
    named)."""
    dev = resolve_device(device)
    with open(path) as f:
        d = parse_settings_yaml(f.read())

    version = d.get("File.version")
    if version is None:
        # legacy ORB-SLAM3-style file (no File.version): different key
        # names, parsed by the reference's Tracking::Parse*ParamFile
        # (tracking.cc:224-933) instead of the Settings class
        return _load_legacy(d, sensor, dev)
    if version != "1.0":
        raise ValueError(
            f"unsupported settings version {version!r} (expected '1.0' "
            "or a legacy no-version file)")

    cam_type = _req(d, "Camera.type")
    if cam_type in ("PinHole", "Rectified"):
        cam_model = "pinhole"
        cam_params = (float(_req(d, "Camera1.fx")),
                      float(_req(d, "Camera1.fy")),
                      float(_req(d, "Camera1.cx")),
                      float(_req(d, "Camera1.cy")))
        distortion = tuple(float(d.get(f"Camera1.{k}", 0.0))
                           for k in ("k1", "k2", "p1", "p2"))
    elif cam_type == "KannalaBrandt8":
        cam_model = "kannala_brandt8"
        cam_params = tuple(
            float(_req(d, f"Camera1.{k}"))
            for k in ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"))
        distortion = ()
    else:
        raise ValueError(f"unknown Camera.type {cam_type!r}")

    width = int(_req(d, "Camera.width"))
    height = int(_req(d, "Camera.height"))
    fps = float(d.get("Camera.fps", 30.0))
    rgb = bool(int(d.get("Camera.RGB", 1)))

    # optional resize (reference settings.cc:375-436)
    new_w = int(d.get("Camera.newWidth", width))
    new_h = int(d.get("Camera.newHeight", height))
    need_resize = (new_w, new_h) != (width, height)
    will_rectify = (cam_type == "PinHole" and "stereo" in sensor
                    and "Camera2.fx" in d)
    if need_resize and not will_rectify:
        # no rectification: scale the intrinsics, System resizes frames
        # (radtan / KB8 distortion acts on normalized coords — unaffected)
        sx, sy = new_w / width, new_h / height
        fx, fy, cx, cy = cam_params[:4]
        cam_params = (fx * sx, fy * sy, cx * sx, cy * sy) + cam_params[4:]
    # when rectifying, the maps below are built at the new size from the
    # ORIGINAL intrinsics and sample the raw full-size image directly
    # (the reference remaps without resizing, system.cc:271-285)
    width, height = new_w, new_h

    baseline = 0.0
    th_depth = float(d.get("Stereo.ThDepth", 60.0))
    rect_maps = None
    rect_R1 = None
    cam2_params = None
    T_c1_c2 = None
    lapping = None
    if "stereo" in sensor:
        T12 = np.asarray(_req(d, "Stereo.T_c1_c2"))
        baseline = float(np.linalg.norm(T12[:3, 3]))
        if cam_type == "KannalaBrandt8" and "Camera2.fx" in d:
            # TUM-VI style fisheye rig: no rectification — descriptor
            # matching in the lapping areas + ray triangulation
            # (reference settings.cc:276-348, frame.cc:1134+)
            cam2_params = tuple(
                float(_req(d, f"Camera2.{k}"))
                for k in ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"))
            T_c1_c2 = T12
            sx = width / int(_req(d, "Camera.width")) if need_resize else 1.0
            lapping = (
                (sx * float(d.get("Camera1.overlappingBegin", 0)),
                 sx * float(d.get("Camera1.overlappingEnd", width))),
                (sx * float(d.get("Camera2.overlappingBegin", 0)),
                 sx * float(d.get("Camera2.overlappingEnd", width))),
            )
        if cam_type == "PinHole" and "Camera2.fx" in d:
            # unrectified pinhole rig -> precompute rectification and
            # replace the calibration with the ideal rectified one
            # (reference Settings::precomputeRectificationMaps,
            # settings.cc:521-563; per-frame remap happens in System)
            from ..frontend.rectify import rectify_map, stereo_rectify
            K1 = np.array([[cam_params[0], 0, cam_params[2]],
                           [0, cam_params[1], cam_params[3]],
                           [0, 0, 1.0]])
            D1 = np.asarray(distortion, np.float64)
            cam2 = tuple(float(_req(d, f"Camera2.{k}"))
                         for k in ("fx", "fy", "cx", "cy"))
            K2 = np.array([[cam2[0], 0, cam2[2]],
                           [0, cam2[1], cam2[3]],
                           [0, 0, 1.0]])
            D2 = np.array([float(d.get(f"Camera2.{k}", 0.0))
                           for k in ("k1", "k2", "p1", "p2")])
            T21 = np.linalg.inv(T12)
            size = (width, height)
            R1, R2, P1, P2 = stereo_rectify(K1, D1, K2, D2,
                                            T21[:3, :3], T21[:3, 3], size)
            rect_maps = (rectify_map(K1, D1, R1, P1[:3, :3], size),
                         rectify_map(K2, D2, R2, P2[:3, :3], size))
            cam_params = (float(P1[0, 0]), float(P1[1, 1]),
                          float(P1[0, 2]), float(P1[1, 2]))
            distortion = (0.0, 0.0, 0.0, 0.0)
            rect_R1 = R1

    calib = None
    if "imu" in sensor:
        Tbc = np.asarray(_req(d, "IMU.T_b_c1"))
        Rbc = Tbc[:3, :3]
        if rect_R1 is not None:
            # camera 1 was rotated by R1: Tbc <- Tbc * (R1, 0)^-1
            # (reference settings.cc:558-563)
            Rbc = Rbc @ rect_R1.T
        calib = make_calib(
            Tbc_R=Rbc.astype(np.float32),
            Tbc_t=Tbc[:3, 3].astype(np.float32),
            noise_gyro=float(_req(d, "IMU.NoiseGyro")),
            noise_acc=float(_req(d, "IMU.NoiseAcc")),
            walk_gyro=float(_req(d, "IMU.GyroWalk")),
            walk_acc=float(_req(d, "IMU.AccWalk")),
            freq=float(_req(d, "IMU.Frequency")),
            device=dev,
        )

    orb = OrbParams(
        n_features=int(d.get("ORBextractor.nFeatures", 1024)),
        num_levels=int(d.get("ORBextractor.nLevels", 8)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        fast_threshold_high=float(d.get("ORBextractor.iniThFAST", 20)),
        fast_threshold_low=float(d.get("ORBextractor.minThFAST", 7)),
    )

    # rectified stereo consumes rectified pixels -> no undistortion in the
    # tracker (the reference rectifies in System::TrackStereo); mono/RGB-D
    # undistort keypoints per frame (Frame::UndistortKeyPoints)
    slam_distortion = () if ("stereo" in sensor or not any(distortion)) \
        else distortion
    slam = SlamConfig(
        cam_model=cam_model,
        cam_params=cam_params,
        distortion=slam_distortion,
        image_size=(height, width),
        fps=fps,
        orb=orb,
        th_far_points=float(d.get("System.thFarPoints", 0.0)),
    )
    return Settings(
        slam=slam,
        calib=calib,
        baseline=baseline,
        th_depth=th_depth,
        fps=fps,
        distortion=distortion,
        load_atlas=d.get("System.LoadAtlasFromFile"),
        save_atlas=d.get("System.SaveAtlasToFile"),
        rect_maps=rect_maps,
        rgb=rgb,
        resize_to=((height, width)
                   if need_resize and rect_maps is None else None),
        th_far_points=float(d.get("System.thFarPoints", 0.0)),
        cam2_params=cam2_params,
        T_c1_c2=T_c1_c2,
        lapping=lapping,
        image_scale=(new_w / int(_req(d, "Camera.width"))
                     if need_resize else 1.0),
    )


def _load_legacy(d: dict, sensor: str, dev) -> Settings:
    """Legacy (no File.version) schema: Camera.fx, Camera.k1..k3, Camera.bf,
    Tbc, Tlr, Camera.lappingBegin/End — the format the reference parses in
    Tracking::ParseCamParamFile / ParseORBParamFile / ParseIMUParamFile
    (tracking.cc:224-933). Pinhole stereo input is assumed pre-rectified
    (scale from Camera.bf); KB8 stereo uses the fisheye rig path."""
    cam_type = str(d.get("Camera.type", "PinHole"))
    scale = float(d.get("Camera.imageScale", 1.0))
    width = int(_req(d, "Camera.width"))
    height = int(_req(d, "Camera.height"))
    fps = float(d.get("Camera.fps", 30.0))
    rgb = bool(int(d.get("Camera.RGB", 1)))
    th_depth = float(d.get("ThDepth", 35.0))

    fx = float(_req(d, "Camera.fx")) * scale
    fy = float(_req(d, "Camera.fy")) * scale
    cx = float(_req(d, "Camera.cx")) * scale
    cy = float(_req(d, "Camera.cy")) * scale

    cam2_params = None
    T_c1_c2 = None
    lapping = None
    if cam_type in ("PinHole", "Rectified"):
        cam_model = "pinhole"
        cam_params = (fx, fy, cx, cy)
        distortion = tuple(float(d.get(f"Camera.{k}", 0.0))
                           for k in ("k1", "k2", "p1", "p2", "k3"))
        if not distortion[4]:
            distortion = distortion[:4]
        if not any(distortion):
            distortion = ()
    elif cam_type == "KannalaBrandt8":
        cam_model = "kannala_brandt8"
        cam_params = (fx, fy, cx, cy) + tuple(
            float(_req(d, f"Camera.{k}")) for k in ("k1", "k2", "k3", "k4"))
        distortion = ()
        if "stereo" in sensor:
            cam2_params = (
                float(_req(d, "Camera2.fx")) * scale,
                float(_req(d, "Camera2.fy")) * scale,
                float(_req(d, "Camera2.cx")) * scale,
                float(_req(d, "Camera2.cy")) * scale,
            ) + tuple(float(_req(d, f"Camera2.{k}"))
                      for k in ("k1", "k2", "k3", "k4"))
            Tlr = np.asarray(_req(d, "Tlr"), np.float64)  # 3x4 T_c1_c2
            T_c1_c2 = np.eye(4)
            T_c1_c2[:3, :] = Tlr
            lapping = (
                (scale * float(d.get("Camera.lappingBegin", 0)),
                 scale * float(d.get("Camera.lappingEnd", width))),
                (scale * float(d.get("Camera2.lappingBegin", 0)),
                 scale * float(d.get("Camera2.lappingEnd", width))),
            )
    else:
        raise ValueError(f"unknown Camera.type {cam_type!r}")

    baseline = 0.0
    if "stereo" in sensor or sensor == "rgbd":
        bf = float(_req(d, "Camera.bf")) * scale
        baseline = bf / fx

    calib = None
    if "imu" in sensor:
        Tbc = np.asarray(_req(d, "Tbc"))
        calib = make_calib(
            Tbc_R=Tbc[:3, :3].astype(np.float32),
            Tbc_t=Tbc[:3, 3].astype(np.float32),
            noise_gyro=float(_req(d, "IMU.NoiseGyro")),
            noise_acc=float(_req(d, "IMU.NoiseAcc")),
            walk_gyro=float(_req(d, "IMU.GyroWalk")),
            walk_acc=float(_req(d, "IMU.AccWalk")),
            freq=float(_req(d, "IMU.Frequency")),
            device=dev,
        )

    orb = OrbParams(
        n_features=int(d.get("ORBextractor.nFeatures", 1024)),
        num_levels=int(d.get("ORBextractor.nLevels", 8)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        fast_threshold_high=float(d.get("ORBextractor.iniThFAST", 20)),
        fast_threshold_low=float(d.get("ORBextractor.minThFAST", 7)),
    )
    new_h, new_w = int(round(height * scale)), int(round(width * scale))
    slam = SlamConfig(
        cam_model=cam_model,
        cam_params=cam_params,
        distortion=() if "stereo" in sensor else distortion,
        image_size=(new_h, new_w),
        fps=fps,
        orb=orb,
        th_far_points=float(d.get("thFarPoints", 0.0)),
    )
    return Settings(
        slam=slam,
        calib=calib,
        baseline=baseline,
        th_depth=th_depth,
        fps=fps,
        distortion=distortion,
        load_atlas=d.get("System.LoadAtlasFromFile"),
        save_atlas=d.get("System.SaveAtlasToFile"),
        rect_maps=None,
        rgb=rgb,
        resize_to=(new_h, new_w) if scale != 1.0 else None,
        th_far_points=float(d.get("thFarPoints", 0.0)),
        cam2_params=cam2_params,
        T_c1_c2=T_c1_c2,
        lapping=lapping,
        depth_map_factor=float(d.get("DepthMapFactor", 1.0)),
        image_scale=scale,
    )
