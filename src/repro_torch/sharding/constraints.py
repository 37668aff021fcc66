"""Sharding constraints usable from model code.

The port's counterpart of the reference's ``repro.sharding.constraints``.
There, ``constrain(x, *axes)`` applies ``with_sharding_constraint``
against the ambient JAX mesh and returns ``x`` unchanged when no mesh is
set. A torch tensor carries no sharding annotation and the port has no
ambient mesh: the distributed engines take their
:class:`~repro_torch.core.device.DeviceMesh` explicitly. So the port
always has the reference's no-mesh behaviour: ``current_axes()`` is
``()`` and ``constrain`` returns its input.
"""
from __future__ import annotations

__all__ = ["constrain", "current_axes"]


def current_axes() -> tuple:
    """Axis names of the ambient mesh: none in the port."""
    return ()


def constrain(x, *spec):
    """Best-effort sharding constraint: ``x`` itself, as the reference
    returns it with no mesh set."""
    return x
