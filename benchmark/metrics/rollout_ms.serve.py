"""Device-stream time a request inside the audio autoregressive rollout: CUDA
events around the built model's audio_triplane."""

from benchmark.readers import span_ms

LAYER = "audio AR rollout (models/audio_net.py, models/transformer.py)"
MOVES = "fps"
UNIT = "ms/req"
SPANS = ("model.audio_triplane",)


def read(run):
    return span_ms(run, SPANS)
