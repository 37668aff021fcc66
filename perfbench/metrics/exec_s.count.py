"""Seconds of one count's execution (plan, tile loop, kernel): the mean
``ExecutionReport.wall_s`` of the window's counts made with the trace
off."""
UNIT = "s"


def read(run):
    t = [c["report"].wall_s for c in run.steady("count")]
    return sum(t) / len(t) if t else None
