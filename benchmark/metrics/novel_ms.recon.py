"""Device-stream ms a reconstruction request in the novel views
(`render_multi_view`, kernel K1): the port's `recon.novel` span, the idle
gaps inside included."""

from benchmark.program_trace import span_ms

LAYER = "renderer (models/renderer.py)"
MOVES = "recon_p90_ms"
UNIT = "ms/req"


def read(run):
    return span_ms(run, "recon.novel")
