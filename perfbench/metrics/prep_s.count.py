"""Seconds of ranking and CSR (``make_order`` + ``preprocess``) of the
cell's graph: the median of three harness spans after a traced count
window."""
import statistics

UNIT = "s"


def read(run):
    t = [b - a for name, a, b in run.spans if name == "prep"]
    return statistics.median(t) if t else None
