"""Kernel SC (csrc/subm_conv.cu, the submanifold sparse conv) against its
bound, at the calls a request makes, over the device time of the kernels
named here in the profiled slice. The reference logs each sparse conv as
`subm_conv` with its arguments' shapes and `pairs`, the present (voxel,
offset) pairs: like spconv, it computes once a voxel, and the rows that
share a voxel take its output; the work counts what those inputs need:

- FLOPs: 2 pairs C_in C_out (a multiply-add a present pair and channel
  pair);
- bytes: the voxels' rows read and written once and the weights read once
  at the operand width, 2 (N C_in + N C_out + k^3 C_in C_out), and the
  neighbour map's int32s, 4 N k^3 (N the level's voxels)."""

from benchmark.readers import roofline

LAYER = "kernels (csrc/)"
MOVES = "fps"
UNIT = "%"
KERNELS = ("subm_conv_kernel",)


def subm_conv_work(calls, elem_bytes=2):
    flops = nbytes = 0
    for c in calls:
        C_out, C_in = c["weight"][0], c["weight"][-1]
        N, K = c["nbr"]
        flops += 2 * c["pairs"] * C_in * C_out
        nbytes += elem_bytes * (N * C_in + N * C_out + K * C_in * C_out) + 4 * N * K
    return flops, nbytes


def read(run):
    return roofline(run, "subm_conv", KERNELS, subm_conv_work)
