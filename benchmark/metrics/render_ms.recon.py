"""Device-stream time a reconstruction request inside the renderer (the
reference view): CUDA events around the built model's renderer."""

from benchmark.readers import span_ms

LAYER = "renderer (models/renderer.py)"
MOVES = "recon_p90_ms"
UNIT = "ms/req"
SPANS = ("model.renderer",)


def read(run):
    return span_ms(run, SPANS)
