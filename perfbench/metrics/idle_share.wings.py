"""Per cent of the traced wing-peeling window in which the device ran
nothing: 1 - the union of device intervals / the traced window."""
from perfbench.devtrace import idle_share

UNIT = "%"


def read(run):
    return idle_share(run, "closed_wings")
