"""Test-support machinery shipped with the package (fault injection)."""
from . import faults

__all__ = ["faults"]
