"""Device resolution for the port's entry points, and the worker mesh.

Every entry point runs on the CUDA card unless its caller asks for the
host with ``device="cpu"``; there is no silent fallback to the CPU.

:class:`DeviceMesh` stands where the reference package takes a
``jax.sharding.Mesh``: the distributed engines run one worker per mesh
slot. It lives here, in ``core``, because ``core`` never imports
``launch`` (the reference's layering rule R2); ``repro_torch.launch.mesh``
builds it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["resolve_device", "visible_count", "worker_device", "DeviceMesh"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when a CUDA device is asked for
    (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev


def visible_count(kind: str) -> int:
    """Visible devices of one type: the CUDA cards, or 1 for the host."""
    return torch.cuda.device_count() if kind == "cuda" else 1


def worker_device(kind: str, worker: int) -> torch.device:
    """Device of mesh worker ``worker``: the visible devices of ``kind``
    taken round-robin, so many workers may share one card (each then
    runs on its own stream)."""
    if kind != "cuda":
        return torch.device(kind)
    return torch.device("cuda", worker % visible_count("cuda"))


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A named grid of worker devices: ``devices`` is an object array of
    ``torch.device`` (``None`` entries in a device-free mesh) whose shape
    is the mesh shape, ``axis_names`` one name per axis."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}"
            )

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def workers(self, axis_names: Optional[Sequence[str]] = None) -> list:
        """The devices of the workers along ``axis_names`` (default: every
        axis), row-major; other axes are taken at index 0, where the
        reference replicates the work."""
        axes = tuple(axis_names or self.axis_names)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        index = tuple(slice(None) if a in axes else 0
                      for a in self.axis_names)
        kept = [a for a in self.axis_names if a in axes]
        sub = self.devices[index]
        # order the kept axes as requested, then flatten row-major
        sub = np.transpose(sub, [kept.index(a) for a in axes])
        return list(sub.reshape(-1))
