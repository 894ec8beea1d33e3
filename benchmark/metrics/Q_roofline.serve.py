"""Kernel Q (csrc/quad_rows.cu) against its bound: the tiles read once and
the quad rows written once, at the shapes of the calls a request makes,
over the device time of the kernels named here in the profiled slice."""

from benchmark.readers import roofline
from benchmark.work import quad_rows_work

LAYER = "kernels (csrc/)"
MOVES = "fps"
UNIT = "%"
KERNELS = ("quad_rows_kernel",)


def read(run):
    return roofline(run, "quad_rows", KERNELS, quad_rows_work)
