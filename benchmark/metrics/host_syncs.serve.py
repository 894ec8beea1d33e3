"""Host syncs a serving request: the places where the host waits for the
card, counted by the port's `profiling.host_sync` (every site together;
standard error names them)."""

from benchmark.program_trace import host_syncs

LAYER = "host loop (serve.py)"
MOVES = "fps"
UNIT = "syncs/req"


def read(run):
    return host_syncs(run)
