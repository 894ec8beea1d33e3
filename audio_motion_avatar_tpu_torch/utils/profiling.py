"""Opt-in instrumentation (the JAX package's utils/profiling.py):

  * `timed` — the mean seconds of a call, fenced on the card by CUDA events
    and a synchronize, on the CPU by the host clock;
  * `trace` — torch.profiler over a block, traces written to a directory;
  * `annotate` — a named range inside a trace (record_function);
  * `device_memory_stats` — the card's allocator statistics in MB;
  * `StageTimer` — accumulating named host-clock stages.

The JAX package's utils/jaxcache.py (its compilation cache) has no
counterpart: the port compiles no graphs, its kernels are built once by
kernels.py.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


def _on_card(out) -> bool:
    if torch.is_tensor(out):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_card(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_card(v) for v in out)
    return False


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1, **kw):
    """(mean seconds of fn(*args, **kw) over `iters` calls, the last
    output), after `warmup` calls. Where the output lies on the card the
    calls are timed by CUDA events around them and a synchronize."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    if _on_card(out):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args, **kw)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    return (time.perf_counter() - t0) / iters, out


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the card's activity too where there
    is one); the trace is written under log_dir. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> dict:
    """In use, peak and total memory of the card in MB ({} without one)."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device("cuda" if device is None else device)
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 1e6,
        "peak_bytes_mb": torch.cuda.max_memory_allocated(device) / 1e6,
        "bytes_limit_mb": torch.cuda.get_device_properties(device).total_memory / 1e6,
    }


class StageTimer:
    """Accumulating named-stage timer for host-side loops."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return " ".join(
            f"{k}={self.totals[k] / max(self.counts[k], 1) * 1e3:.1f}ms"
            for k in self.totals)
