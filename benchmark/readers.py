"""What the metric files in metrics/ share: each reads one number from a
run (harness.Run) and returns None where the run has nothing to read."""

from __future__ import annotations

from .chip import PEAK_BF16_FLOPS
from .work import kernel_bound_ms


def span_ms(run, paths) -> float | None:
    """Milliseconds a request between the CUDA events at the entry and exit
    of the spans at `paths`: their stretch of the device's stream, the
    idle gaps inside it included."""
    if not run.spans_ms or not all(p in run.spans_ms for p in paths):
        return None
    return sum(run.spans_ms[p] for p in paths) / run.requests


def roofline(run, kind: str, kernels, work) -> float | None:
    """% of its bound: the bound of a request's `kind` calls (the logged
    calls of the reference's function of that kind, counted by `work`, see
    work.py) times the profiled requests, over the device time of the
    kernels named."""
    calls = run.calls.get(kind)
    if run.slice is None or not calls:
        return None
    spent = run.slice.seconds(kernels)
    if spent == 0:
        return None
    bound_s = kernel_bound_ms(work, calls, run.elem_bytes) * 1e-3 * run.slice.requests
    return 100.0 * bound_s / spent


def mfu(run) -> float | None:
    """% of the bf16 peak: a request's model FLOPs times the requests of the
    host-timed window, over the window."""
    if run.flops_per_request is None:
        return None
    return 100.0 * run.flops_per_request * run.requests / (run.window_s * PEAK_BF16_FLOPS)


def idle_share(run) -> float | None:
    """% of the window in which nothing ran on the device: 1 - the device's
    busy seconds a request (the union of its activity in the profiled
    slice) over the window's seconds a request (host clock, no profiler,
    whose own overhead stretches the slice's wall time)."""
    if run.slice is None:
        return None
    busy = run.slice.busy_s / run.slice.requests
    return 100.0 * (1.0 - busy * run.requests / run.window_s)


def launches(run) -> float | None:
    """Device kernels a request in the profiled slice."""
    if run.slice is None:
        return None
    return run.slice.launches / run.slice.requests
