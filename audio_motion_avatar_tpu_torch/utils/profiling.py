"""The port's instrumentation: one process-global tracer, off by default,
a host-sync counter, and `trace`, the torch.profiler exporter.

Spans. `span(name)` is a context manager around a stage of a request.
While the tracer is off it returns one shared no-op object: an attribute
check, no allocation, no CUDA call. While it is on, a span inside an open
request records its name, its parent span and its request's id, the host
clock (`time.perf_counter_ns`) at entry and exit and, for a request on
the card, a CUDA timing event at entry and at exit on the current stream.
Nothing synchronises on the way: the events are resolved when the records
are read. Spans outside a request are not recorded.

Requests. `request(name, device)` opens a request's top span; at its exit
the request's spans and its host syncs become one record, kept in a ring
of the last `RING` requests. A request opened inside another is a span of
the outer one.

Records. `records()` synchronises once, resolves the events and returns
every record in the ring, oldest first:

    {"id": 3, "name": "serve.request", "syncs": {site: count},
     "spans": [{"name", "parent", "host_start_ns", "host_end_ns", "host_ms",
                "device_start_ns", "device_end_ns", "device_ms"}, ...]}

in the order the spans were entered. `device_ms` is the device stream's
stretch between the span's two events (idle gaps inside it included);
the device edges are given on the host clock too, as an anchor's host
time plus the anchor event's `elapsed_time` to each edge, so a span's
host and device times compare directly. The anchor (synchronise, record
an event, read the host clock) is taken when the tracer is enabled with
CUDA initialised, else at the first request on the card, and again at
each `records()`. On the CPU the device fields are None.

Host syncs. `host_sync(site)` wraps a place where the host waits for the
card (a read-back, a size read, a copy from host memory):

    with profiling.host_sync("recon.metrics"):
        value = float(tensor)

It counts per site whether or not the tracer is on (`syncs()`), and per
request in the request's record while it is on. It changes nothing of
what the wrapped code does.

Profiler mode. `trace(log_dir)` runs torch.profiler over a block with the
tracer on, and every span also opens a `torch.profiler.record_function`
range: in the Kineto trace written under log_dir the stages sit beside
the kernels on the profiler's clock. Only `trace` does that: with the
tracer merely enabled, a profiler run sees no range of the program's,
since each range would also appear as a device-side annotation.

The tracer is meant for one thread (the serving loop, the
reconstruction): spans of concurrent requests on two threads would nest
into one another.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import torch

RING = 4096     # requests kept


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _NoOp()


class _Request:
    """A request being served: its spans as [name, parent, host start,
    host end, start event, end event] lists and its host syncs, until
    `resolve` turns them into the record."""

    __slots__ = ("id", "name", "cuda", "anchor", "spans", "syncs", "record")

    def __init__(self, rid: int, name: str, cuda: bool, anchor):
        self.id, self.name, self.cuda, self.anchor = rid, name, cuda, anchor
        self.spans: list = []
        self.syncs: collections.Counter = collections.Counter()
        self.record: Optional[dict] = None

    def resolve(self) -> dict:
        """The record (after a synchronize where events are pending)."""
        if self.record is None:
            spans = [_resolve_span(s, self.anchor) for s in self.spans]
            self.record = {"id": self.id, "name": self.name, "syncs": dict(self.syncs),
                           "spans": spans}
            self.spans = None
        return self.record


def _resolve_span(s, anchor) -> dict:
    name, parent, t0, t1, e0, e1 = s
    out = {"name": name, "parent": parent, "host_start_ns": t0, "host_end_ns": t1,
           "host_ms": (t1 - t0) * 1e-6, "device_start_ns": None, "device_end_ns": None,
           "device_ms": None}
    if e0 is not None:
        ev, host_ns = anchor
        out.update(device_start_ns=host_ns + round(ev.elapsed_time(e0) * 1e6),
                   device_end_ns=host_ns + round(ev.elapsed_time(e1) * 1e6),
                   device_ms=e0.elapsed_time(e1))
    return out


class Tracer:
    """The state behind the module's functions (one per process,
    `TRACER`)."""

    def __init__(self, ring: int = RING):
        self.on = False
        self.annotate = False                 # profiler mode: record_function ranges too
        self.ring: collections.deque = collections.deque(maxlen=ring)
        self.counts: collections.Counter = collections.Counter()   # host syncs by site
        self.open: Optional[_Request] = None
        self.stack: List[str] = []            # names of the open request's open spans
        self.anchor = None                    # (CUDA event, host ns)
        self.next_id = 0

    def take_anchor(self) -> None:
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.anchor = (ev, time.perf_counter_ns())


TRACER = Tracer()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name, self.rec, self.rf = name, None, None

    def __enter__(self):
        tr = TRACER
        if tr.annotate:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        req = tr.open
        if req is not None:
            self.rec = [self.name, tr.stack[-1] if tr.stack else None,
                        time.perf_counter_ns(), None, None, None]
            if req.cuda:
                self.rec[4] = torch.cuda.Event(enable_timing=True)
                self.rec[4].record()
            req.spans.append(self.rec)
            tr.stack.append(self.name)
        return None

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            rec[3] = time.perf_counter_ns()
            if rec[4] is not None:
                rec[5] = torch.cuda.Event(enable_timing=True)
                rec[5].record()
            TRACER.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _RequestSpan(_Span):
    __slots__ = ("device",)

    def __init__(self, name: str, device):
        super().__init__(name)
        self.device = device

    def __enter__(self):
        tr = TRACER
        cuda = torch.device(self.device).type == "cuda" if self.device is not None else False
        if cuda and tr.anchor is None:
            tr.take_anchor()
        tr.open = _Request(tr.next_id, self.name, cuda, tr.anchor)
        tr.next_id += 1
        tr.stack = []
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        tr = TRACER
        tr.ring.append(tr.open)
        tr.open = None
        return False


def span(name: str):
    """A stage of the open request (see the module docstring)."""
    if not TRACER.on:
        return NOOP
    return _Span(name)


def request(name: str, device=None):
    """A request's top span; device: where it runs (CUDA events on "cuda")."""
    if not TRACER.on:
        return NOOP
    if TRACER.open is not None:
        return _Span(name)
    return _RequestSpan(name, device)


def host_sync(site: str):
    """Count one host sync at `site` (per site always, per request while
    the tracer is on); a context manager around the wait."""
    tr = TRACER
    tr.counts[site] += 1
    if tr.open is not None:
        tr.open.syncs[site] += 1
    return NOOP


def syncs() -> Dict[str, int]:
    """Host syncs by site since the process started (or `reset`)."""
    return dict(TRACER.counts)


def enable() -> None:
    """Turn the tracer on (the anchor taken now where CUDA is initialised)."""
    tr = TRACER
    if not tr.on and torch.cuda.is_available() and torch.cuda.is_initialized():
        tr.take_anchor()
    tr.on = True


def disable() -> None:
    TRACER.on = False


def reset() -> None:
    """Drop the records and the sync counts (the tracer stays as it is)."""
    TRACER.ring.clear()
    TRACER.counts.clear()


def records() -> List[dict]:
    """Every request in the ring as a record, oldest first (synchronises
    once where events are pending, then takes a new anchor)."""
    tr = TRACER
    cuda = any(r.cuda and r.record is None for r in tr.ring)
    if cuda:
        torch.cuda.synchronize()
    out = [r.resolve() for r in tr.ring]
    if cuda:
        tr.take_anchor()
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the card's activity too where there
    is one) with the tracer on and every span a record_function range;
    the trace is written under log_dir. Yields the profiler."""
    tr = TRACER
    was = tr.on, tr.annotate
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    enable()
    tr.annotate = True
    try:
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
            yield prof
    finally:
        tr.on, tr.annotate = was
