"""Milliseconds one peeling round waits on blocking device-to-host
fetches: the program's ``peel.round.fetch`` span over its ``rounds``
counter, summed over the window's decompositions made after the trace
stopped."""
UNIT = "ms"


def read(run):
    wait = rounds = 0
    for c in run.steady("peel"):
        rep = c["report"]
        ph = getattr(rep, "phases", {})
        if "peel.round.fetch" not in ph:
            continue
        wait += ph["peel.round.fetch"].s
        rounds += rep.counters.get("rounds", 0)
    return 1e3 * wait / rounds if rounds else None
