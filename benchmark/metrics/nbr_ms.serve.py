"""Device-stream ms a serving request building the PT-v3m1 refiner's
neighbour maps (the voxel keys, their sort and one searchsorted a (voxel,
offset)): the port's `refine.nbr` spans, summed, the idle gaps inside
included. Only the "pointcept" refiner has them."""

from benchmark.program_trace import span_ms

LAYER = "PTv3 refiner (models/ptv3.py, ops/sparse_conv.py)"
MOVES = "fps"
UNIT = "ms/req"


def read(run):
    return span_ms(run, "refine.nbr")
