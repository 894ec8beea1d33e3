"""Device kernels a serving request, counted in the profiled slice."""

from benchmark.readers import launches

LAYER = "host loop (serve.py)"
MOVES = "fps"
UNIT = "launches/req"


def read(run):
    return launches(run)
