"""Seconds of ranking (``make_order``) in one count: the mean of the
program's ``count.rank`` span over the window's counts made after the
trace stopped."""
UNIT = "s"


def read(run):
    t = [c["report"].phases["count.rank"].s for c in run.steady("count")
         if "count.rank" in getattr(c["report"], "phases", {})]
    return sum(t) / len(t) if t else None
