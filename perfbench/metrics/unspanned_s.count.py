"""Seconds of one count that no span of the program covers: the
harness's wall of the call less the time in the direct children of the
program's root span ``count`` (the root's time less its self time),
the mean over the window's counts made after the trace stopped."""
UNIT = "s"


def read(run):
    t = []
    for c in run.steady("count"):
        root = getattr(c["report"], "phases", {}).get("count")
        if root is not None:
            t.append((c["t1"] - c["t0"]) - (root.s - root.self_s))
    return sum(t) / len(t) if t else None
