"""Worker meshes for the distributed engines.

The counterpart of the reference's ``repro.launch.mesh``: it builds the
:class:`~repro_torch.core.device.DeviceMesh` that
``core.distributed`` takes where the reference takes a
``jax.sharding.Mesh``. Functions, not module constants, so importing
this module touches no device. The reference's ``HAS_AXIS_TYPE`` (a
JAX version shim) has no counterpart.
"""
from __future__ import annotations

import numpy as np

from ..core.device import (
    DeviceMesh,
    resolve_device,
    visible_count,
    worker_device,
)

__all__ = [
    "make_production_mesh",
    "make_test_mesh",
    "abstract_mesh",
    "available_devices",
]


def available_devices(device=None) -> int:
    """Visible devices of ``device``'s type (``None`` means CUDA): the
    width to hand the ``devices=`` knob of the peeling entry points.
    Core code takes an explicit integer (or resolves ``"auto"`` itself)
    and never imports this module."""
    return visible_count(resolve_device(device).type)


def _mesh(shape, axes, kind: str) -> DeviceMesh:
    shape = tuple(int(s) for s in shape)
    workers = [worker_device(kind, i) for i in range(int(np.prod(shape)))]
    devices = np.empty(len(workers), dtype=object)
    devices[:] = workers
    return DeviceMesh(devices.reshape(shape), tuple(axes))


def make_test_mesh(shape=(1,), axes=("data",), device=None) -> DeviceMesh:
    """A mesh of ``shape`` workers over the visible devices of
    ``device``'s type, round-robin: many workers may share one card or
    the host, the counterpart of the reference's forced host devices."""
    return _mesh(shape, axes, resolve_device(device).type)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """16x16 = 256 workers (``("data", "model")``); 2x16x16 = 512 with
    ``multi_pod`` (``("pod", "data", "model")``). Needs one real device
    per worker and raises otherwise, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    kind = resolve_device(device).type
    need, have = int(np.prod(shape)), visible_count(kind)
    if have < need:
        raise ValueError(
            f"a {shape} mesh needs {need} {kind} devices, {have} visible"
        )
    return _mesh(shape, axes, kind)


def abstract_mesh(shape, axes) -> DeviceMesh:
    """Device-free mesh (every slot ``None``) for mesh-shape-only rule
    resolution."""
    devices = np.full(tuple(int(s) for s in shape), None, dtype=object)
    return DeviceMesh(devices, tuple(axes))
