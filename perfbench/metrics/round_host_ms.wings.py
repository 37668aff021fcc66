"""Host milliseconds of one wing-peeling round: the program's
``peel.round.select`` and ``peel.round.expand`` spans (the expansion's
self time, without the fetch inside it) over its ``rounds`` counter,
summed over the window's decompositions made after the trace stopped."""
UNIT = "ms"


def read(run):
    host = rounds = 0
    for c in run.steady("wings"):
        rep = c["report"]
        ph = getattr(rep, "phases", {})
        if "peel.round.select" not in ph or "peel.round.expand" not in ph:
            continue
        host += ph["peel.round.select"].s + ph["peel.round.expand"].self_s
        rounds += rep.counters.get("rounds", 0)
    return 1e3 * host / rounds if rounds else None
