"""The work a request needs, counted from the function and not from the
program: kernel bounds from the arguments of the calls that stand where the
port launches a kernel (logged by the reference's `logged` functions,
`reference.plain_avatar.ops.calls`: a tensor as its shape), and a
request's model FLOPs from FlopCounterMode over the reference's forward.

A work function takes a list of logged calls and the operand width in
bytes and returns (FLOPs, bytes). The bytes count each operand once at the
port's operand width (bf16: 2 bytes); the FLOPs count a multiply-add as
two. A roofline metric names its work function in its own file
(metrics/<name>.py), so a later one brings its own.
"""

from __future__ import annotations

import math
from typing import Iterable

from .chip import bound_ms


def attention_work(calls: Iterable[dict], elem_bytes: int = 2):
    """(FLOPs, bytes) of softmax(q k^T) v calls: 4 B H Sq Skv D FLOPs
    (q k^T and p v), and q, k, v, o read or written once (a key mask of
    B Skv bytes besides)."""
    flops = nbytes = 0
    for c in calls:
        B, H, Sq, D = c["q"]
        Skv = c["k"][2]
        flops += 4 * B * H * Sq * Skv * D
        nbytes += elem_bytes * B * H * D * (2 * Sq + 2 * Skv) + (B * Skv if c["kv_mask"] else 0)
    return flops, nbytes


def quad_rows_work(calls: Iterable[dict], elem_bytes: int = 2):
    """(FLOPs, bytes) of the quad-row build: the tiles (FP, cap, T, T, C)
    read once and the rows (FP, cap, T, T, 4C) written once; no arithmetic."""
    nbytes = 0
    for c in calls:
        nbytes += elem_bytes * 5 * math.prod(c["tiles"])
    return 0, nbytes


def kernel_bound_ms(work, calls: Iterable[dict], elem_bytes: int = 2) -> float:
    """The least time the card could take for `calls` of a kernel whose
    function does `work(calls, elem_bytes)`."""
    flops, nbytes = work(calls, elem_bytes)
    return bound_ms(flops, nbytes)


def counted_flops(fn) -> int:
    """FLOPs of the matmuls, convolutions and attention that `fn()` runs
    (torch.utils.flop_counter; elementwise work is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()
