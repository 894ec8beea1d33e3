"""90th percentile of every reconstruction request's latency in the
window, host clock around the request to its synchronize."""

from benchmark.harness import p90

UNIT = "ms"


def read(run):
    return 1e3 * p90(run.latencies_s)
