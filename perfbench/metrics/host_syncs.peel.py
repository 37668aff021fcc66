"""Blocking device-to-host reads of one decomposition: the mean
``ExecutionReport.host_syncs`` of the window's decompositions."""
UNIT = "syncs"


def read(run):
    s = [c["report"].host_syncs for c in run.steady("peel")]
    return sum(s) / len(s) if s else None
