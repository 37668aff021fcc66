"""Milliseconds of one wing-peeling round: the decompositions' (made
with the trace off) ``ExecutionReport.wall_s`` over their
``host_syncs`` (one a round)."""
UNIT = "ms"


def read(run):
    reps = [c["report"] for c in run.steady("wings")]
    syncs = sum(r.host_syncs for r in reps)
    return 1e3 * sum(r.wall_s for r in reps) / syncs if syncs else None
