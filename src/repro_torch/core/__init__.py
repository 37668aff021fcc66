"""ParButterfly core: exact and approximate butterfly counting and
peeling in PyTorch."""
from .graph import BipartiteGraph, RankedGraph, preprocess
from .ranking import RANKINGS, make_order, wedges_processed
from .count import CountResult, count_butterflies, count_from_ranked
from .approx import ApproxCount, SampleState, sample_count
from .sparsify import approx_count, sparsify_colorful, sparsify_edges
from .fibheap import BucketStructure, FibHeap
from .peel import PeelResult, peel_tips, peel_tips_stored, peel_wings
from .checkpoint import CheckpointStore, RoundCheckpoint
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
    "ApproxCount",
    "SampleState",
    "sample_count",
    "approx_count",
    "sparsify_edges",
    "sparsify_colorful",
    "PeelResult",
    "peel_tips",
    "peel_tips_stored",
    "peel_wings",
    "CheckpointStore",
    "RoundCheckpoint",
    "FibHeap",
    "BucketStructure",
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
