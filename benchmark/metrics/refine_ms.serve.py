"""Device-stream ms a serving request in the PTv3 point refiner and the refine
MLP: the port's `render.refine` span, each frame chunk's summed, the idle
gaps inside included."""

from benchmark.program_trace import span_ms

LAYER = "renderer (models/renderer.py)"
MOVES = "fps"
UNIT = "ms/req"


def read(run):
    return span_ms(run, "render.refine")
