"""Device-stream time a request inside the Sapiens ViT: CUDA events around the
built model's sapiens_encoder."""

from benchmark.readers import span_ms

LAYER = "stage-1 encoders (models/image_encoder.py, models/triplane_encoder.py, models/fusion.py)"
MOVES = "recon_p90_ms"
UNIT = "ms/req"
SPANS = ("model.sapiens_encoder",)


def read(run):
    return span_ms(run, SPANS)
