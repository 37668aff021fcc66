"""Seconds one count waits for the card: the mean of the program's
``count.to_host`` span (the blocking device-to-host copy after the
kernel's enqueue) over the window's counts made after the trace stopped."""
UNIT = "s"


def read(run):
    t = [c["report"].phases["count.to_host"].s for c in run.steady("count")
         if "count.to_host" in getattr(c["report"], "phases", {})]
    return sum(t) / len(t) if t else None
