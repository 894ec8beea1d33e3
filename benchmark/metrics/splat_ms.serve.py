"""Device-stream ms a serving request from the fused gaussian heads to the
frames (projection, binning, sort, kernel S): the port's `render.splat`
span, each frame chunk's summed, the idle gaps inside included."""

from benchmark.program_trace import span_ms

LAYER = "renderer (models/renderer.py)"
MOVES = "fps"
UNIT = "ms/req"


def read(run):
    return span_ms(run, "render.splat")
