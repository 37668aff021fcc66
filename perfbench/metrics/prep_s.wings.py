"""Seconds of one wing decomposition before its round loop: the mean
over the window's decompositions made after the trace stopped of the
program's ``peel.count`` + ``peel.csr`` + ``peel.wing_totals`` +
``peel.setup`` spans."""
UNIT = "s"
SPANS = ("peel.count", "peel.csr", "peel.wing_totals", "peel.setup")


def read(run):
    t = []
    for c in run.steady("wings"):
        ph = getattr(c["report"], "phases", {})
        if all(k in ph for k in SPANS):
            t.append(sum(ph[k].s for k in SPANS))
    return sum(t) / len(t) if t else None
