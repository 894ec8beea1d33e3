"""Device-stream ms a serving request in the PT-v3m1 refiner's level
read-back, grid pooling and unpooling: the port's `refine.pool` spans,
summed, the idle gaps inside (the read-back's wait among them) included.
Only the "pointcept" refiner has them."""

from benchmark.program_trace import span_ms

LAYER = "PTv3 refiner (models/ptv3.py, ops/sparse_conv.py)"
MOVES = "fps"
UNIT = "ms/req"


def read(run):
    return span_ms(run, "refine.pool")
