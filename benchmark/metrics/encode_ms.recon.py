"""Device-stream time a request inside the SMPL-X triplane encoder and the fusion
transformer: CUDA events around each, summed."""

from benchmark.readers import span_ms

LAYER = "stage-1 encoders (models/image_encoder.py, models/triplane_encoder.py, models/fusion.py)"
MOVES = "recon_p90_ms"
UNIT = "ms/req"
SPANS = ("model.smplx_triplane_encoder", "model.fusion_network")


def read(run):
    return span_ms(run, SPANS)
