"""PyTorch/CUDA port of the orb_slam_fusion_tpu SLAM engine.

The JAX package ``orb_slam_fusion_tpu`` is the reference; this package
mirrors its subpackage layout (``frontend/``, ``map/``, ``imu/``,
``solver/``, ``engine/``) and function names so each counterpart is easy to find. It
imports ``torch`` and numpy only.

Entry points that create tensors take a ``device`` argument. Left unset it
means CUDA, and without a CUDA device they raise instead of silently
running on the CPU; tests pass ``device="cpu"`` explicitly. Functions that
take tensors run on the device of their inputs.

Numerics: float32 matrix products and cuDNN convolutions are pinned to
full fp32 (no TF32) at import, because the ORB front end compares pixel
differences bit for bit with the reference.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no device is named and no CUDA device exists, so a run
    meant for the GPU never falls back to the CPU unnoticed.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def __getattr__(name):
    """``System`` and ``Sensor``, the front door, from the package's top
    level (imported on first use, so importing the package stays light)."""
    if name in ("System", "Sensor"):
        from . import system
        return getattr(system, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
