"""ParButterfly core: exact butterfly counting in PyTorch."""
from .graph import BipartiteGraph, RankedGraph, preprocess
from .ranking import RANKINGS, make_order, wedges_processed
from .count import CountResult, count_butterflies, count_from_ranked
from .resilience import (
    AccumulatorOverflowRisk,
    CapacityOverflow,
    CheckpointCorrupt,
    DeviceLost,
    ExecutionReport,
    GraphValidationError,
    ResilienceError,
    ResiliencePolicy,
    ResourceExhausted,
    ResultInvariantViolation,
    RungUnavailable,
    StragglerTimeout,
)

__all__ = [
    "BipartiteGraph",
    "RankedGraph",
    "preprocess",
    "RANKINGS",
    "make_order",
    "wedges_processed",
    "CountResult",
    "count_butterflies",
    "count_from_ranked",
    "ResilienceError",
    "GraphValidationError",
    "CapacityOverflow",
    "AccumulatorOverflowRisk",
    "DeviceLost",
    "ResourceExhausted",
    "RungUnavailable",
    "ResultInvariantViolation",
    "StragglerTimeout",
    "CheckpointCorrupt",
    "ExecutionReport",
    "ResiliencePolicy",
]
