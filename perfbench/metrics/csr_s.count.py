"""Seconds of the CSR build (``preprocess``) in one count: the mean of
the program's ``count.csr`` span over the window's counts made after the
trace stopped."""
UNIT = "s"


def read(run):
    t = [c["report"].phases["count.csr"].s for c in run.steady("count")
         if "count.csr" in getattr(c["report"], "phases", {})]
    return sum(t) / len(t) if t else None
