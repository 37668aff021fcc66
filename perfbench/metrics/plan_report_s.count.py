"""Seconds of one count's report-only planning pass (a second
``host_wedge_counts`` and ``plan_count`` before the ladder): the mean of
the program's ``count.plan_report`` span over the window's counts made
after the trace stopped."""
UNIT = "s"


def read(run):
    t = [c["report"].phases["count.plan_report"].s
         for c in run.steady("count")
         if "count.plan_report" in getattr(c["report"], "phases", {})]
    return sum(t) / len(t) if t else None
