"""Device-stream ms a serving request in the SMPL-X decoder over the chunk's
output tokens: the port's `decode` span, the idle gaps inside included."""

from benchmark.program_trace import span_ms

LAYER = "SMPL-X decoder (models/smplx_decoder.py)"
MOVES = "fps"
UNIT = "ms/req"


def read(run):
    return span_ms(run, "decode")
