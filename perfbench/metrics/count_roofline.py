"""Per cent of the counting problem's roofline (``perfbench.roofline``)
that one count's kernels reach: the least time over the profiler's
kernel time per traced count, whatever the kernels' names."""
from perfbench.roofline import count_bound

UNIT = "%"


def read(run):
    tr, f = run.tracer, run.facts
    if run.kind_name != "closed_count" or not tr.kernel_s or not tr.calls \
            or "wedges" not in f:
        return None
    bound_s, _by = count_bound(f["n"], f["m"], f["wedges"])
    return 100.0 * bound_s / (tr.kernel_s / tr.calls)
