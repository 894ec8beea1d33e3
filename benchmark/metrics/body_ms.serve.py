"""Device-stream ms a serving request in SMPL-X FK/LBS, the midpoint
subdivision and the sub-selection (`Renderer.get_vertices`): the port's
`render.body` span, the idle gaps inside included."""

from benchmark.program_trace import span_ms

LAYER = "renderer (models/renderer.py)"
MOVES = "fps"
UNIT = "ms/req"


def read(run):
    return span_ms(run, "render.body")
