"""Seconds of the host planning inside one count's ``fused_cuda`` rung:
the mean over the window's counts made after the trace stopped of the
program's ``count.wedge_counts`` + ``count.plan`` + ``count.work_list``
spans."""
UNIT = "s"
SPANS = ("count.wedge_counts", "count.plan", "count.work_list")


def read(run):
    t = []
    for c in run.steady("count"):
        ph = getattr(c["report"], "phases", {})
        if all(k in ph for k in SPANS):
            t.append(sum(ph[k].s for k in SPANS))
    return sum(t) / len(t) if t else None
