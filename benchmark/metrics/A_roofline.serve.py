"""Kernel A (csrc/attention.cu) against its bound: 4 B H Sq Skv D FLOPs a
call and q, k, v, o moved once, at the shapes of the calls a request makes,
over the device time of the kernels named here in the profiled slice."""

from benchmark.readers import roofline
from benchmark.work import attention_work

LAYER = "kernels (csrc/)"
MOVES = "fps"
UNIT = "%"
KERNELS = ("attn_fwd_kernel",)


def read(run):
    return roofline(run, "attention", KERNELS, attention_work)
