"""The model's FLOPs a request (FlopCounterMode over the reference's
forward: matmuls, convolutions, attention) times the requests of the
host-timed window, over the window at the bf16 peak."""

from benchmark.readers import mfu

LAYER = "model step"
MOVES = "recon_p90_ms"
UNIT = "%"


def read(run):
    return mfu(run)
