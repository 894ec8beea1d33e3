"""Device-stream time a serving request inside the renderer: CUDA events around
the built model's renderer."""

from benchmark.readers import span_ms

LAYER = "renderer (models/renderer.py)"
MOVES = "fps"
UNIT = "ms/req"
SPANS = ("model.renderer",)


def read(run):
    return span_ms(run, SPANS)
