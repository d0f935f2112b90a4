"""A one-controller device mesh with explicit shards.

Counterpart of the reference's ``jax.sharding.Mesh`` over the axis
``"mp"`` and its ``shard_map`` bodies: one Python process drives every
shard. ``SlamMesh`` holds an ordered list of torch devices (a device may
repeat: ``[cpu] * 8`` is the counterpart of JAX's 8 virtual host devices,
``[cuda:0] * 8`` runs the 8-way split on one card).

* ``shard(x, fill)`` pads the leading axis to a multiple of D with
  ``fill`` and puts contiguous shard d on ``devices[d]``;
* ``psum(partials)`` adds the D partials on ``devices[0]`` one after the
  other in rank order, so a run repeats to the bit on every backend
  (ROADMAP H5), and returns the sum there;
* replicated work (the reduced-camera solve, a pose update) is computed
  once on ``devices[0]`` and copied to each shard's device with
  ``replicate``, so the replicas are identical by construction;
* ``gather(shards)`` puts the shards back together on ``devices[0]``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def tree_to(x, dev: torch.device):
    """``x`` (a tensor, a NamedTuple of them, or None) on ``dev``."""
    if x is None:
        return x
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_to(v, dev) for v in x))
    raise TypeError(f"cannot move {type(x).__name__} to a device")


class SlamMesh:
    """An ordered list of devices along the mesh axis ``"mp"``."""

    def __init__(self, devices: Sequence):
        if len(devices) < 1:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d)
                                            for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self):
        """``{"mp": D}``, as the reference's ``mesh.shape``."""
        return {"mp": self.size}

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def pad(self, x: torch.Tensor, fill=0) -> torch.Tensor:
        """``x`` with its leading axis padded to a multiple of D."""
        pad = (-x.shape[0]) % self.size
        if pad == 0:
            return x
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    def shard(self, x: torch.Tensor, fill=0) -> List[torch.Tensor]:
        """D contiguous shards of the padded leading axis, shard d on
        ``devices[d]``."""
        x = self.pad(x, fill)
        n = x.shape[0] // self.size
        return [x[d * n:(d + 1) * n].to(dev)
                for d, dev in enumerate(self.devices)]

    def replicate(self, x) -> list:
        """``x`` (a tensor or a NamedTuple of them) on every device."""
        return [tree_to(x, dev) for dev in self.devices]

    def psum(self, partials):
        """Sum of the D partials (tensors or tuples of them) on
        ``devices[0]``, added in rank order."""
        first = partials[0]
        if isinstance(first, (tuple, list)):
            return type(first)(self.psum([p[i] for p in partials])
                               for i in range(len(first)))
        out = first.to(self.home)
        for p in partials[1:]:
            out = out + p.to(self.home)
        return out

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The shards concatenated along the leading axis on
        ``devices[0]``."""
        return torch.cat([s.to(self.home) for s in shards])


def make_slam_mesh(n_devices: int | None = None, devices=None) -> SlamMesh:
    """1-D mesh over the landmark axis.

    By default the first ``n_devices`` CUDA devices (every one when None);
    raises when there is no CUDA device and no ``devices`` is given, and
    never falls back to the CPU. An explicit ``devices`` list may repeat a
    device.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_slam_mesh: no CUDA device available; pass devices= "
                "(e.g. [torch.device('cpu')] * 8) to build a mesh on the "
                "CPU explicitly")
        n = torch.cuda.device_count()
        if n_devices:
            n = min(int(n_devices), n)
        devices = [torch.device("cuda", i) for i in range(n)]
    return SlamMesh(devices)
