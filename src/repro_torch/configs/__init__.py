from .base import ArchConfig, ShapeCell, SHAPE_CELLS
from .registry import ARCH_IDS, all_configs, get_config

__all__ = [
    "ArchConfig",
    "ShapeCell",
    "SHAPE_CELLS",
    "ARCH_IDS",
    "all_configs",
    "get_config",
]
