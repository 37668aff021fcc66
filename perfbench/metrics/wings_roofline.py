"""Per cent of the wing problem's roofline (``perfbench.wing_roofline``)
that one decomposition's kernels reach: the least time over the
profiler's kernel time per traced decomposition, whatever the kernels'
names."""
from perfbench.wing_roofline import wing_bound

UNIT = "%"


def read(run):
    tr, f = run.tracer, run.facts
    if run.kind_name != "closed_wings" or not tr.kernel_s or not tr.calls \
            or "triples" not in f:
        return None
    bound_s, _by = wing_bound(f["m"], f["triples"])
    return 100.0 * bound_s / (tr.kernel_s / tr.calls)
