"""The share of the profiled slice in which no operation ran on the
device (1 - the union of device activity over the slice's wall time)."""

from benchmark.readers import idle_share

LAYER = "device (H100)"
MOVES = "fps"
UNIT = "%"


def read(run):
    return idle_share(run)
