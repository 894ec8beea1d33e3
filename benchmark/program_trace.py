"""The port's own tracer (`audio_motion_avatar_tpu_torch/utils/profiling.py`)
as the per-layer metrics read it.

Importing this module turns the tracer on. Only the metric files that read
the program's spans and host-sync counts import it, and the harness loads a
cell's per-layer readers only with `--trace 1`: a `--trace 0` run never
turns the tracer on. The tracer alone opens no `record_function` range, so
the profiled slice (tracing.Slice) sees none of it.

The harness loads the readers before set-up, so the tracer records every
request of a run, in the harness's order: the warm-up, the window, the
profiled slice. `window(run)` picks the window's records out of them.
Against a port whose profiling module has no tracer (a tree before it), the
readers find nothing and return None.
"""

from __future__ import annotations

import collections
import statistics
import sys
from typing import List, Optional

from audio_motion_avatar_tpu_torch.utils import profiling

TRACING = hasattr(profiling, "enable") and hasattr(profiling, "records")
if TRACING:
    profiling.enable()

_last: list = [None, None]      # [run, its window's records]


def pick(records: List[dict], window: int, profiled: int) -> Optional[List[dict]]:
    """The `window` records before the last `profiled` ones; None where
    fewer were kept."""
    if len(records) < window + profiled:
        return None
    end = len(records) - profiled
    return records[end - window:end]


def window(run) -> Optional[List[dict]]:
    """The records of the window's requests (run.requests of them, just
    before the profiled slice's run.slice.requests); None without the
    tracer, without a profiled slice, or where the ring kept too few. The
    first call for a run prints each span's mean device-stream and host ms
    a request and the host syncs a request by site to standard error."""
    if _last[0] is run:
        return _last[1]
    recs = None
    if TRACING and run.slice is not None:
        recs = pick(profiling.records(), run.requests, run.slice.requests)
    _last[:] = [run, recs]
    if recs:
        report(recs)
    return recs


def per_request(recs: List[dict], name: str, field: str) -> Optional[float]:
    """The mean over requests of the sum of `field` over the spans named
    `name`; None where no request has such a span or a value is missing."""
    sums, seen = [], False
    for r in recs:
        vals = [s[field] for s in r["spans"] if s["name"] == name]
        if None in vals:
            return None
        seen = seen or bool(vals)
        sums.append(sum(vals))
    return statistics.fmean(sums) if seen else None


def report(recs: List[dict]) -> None:
    names = list(dict.fromkeys(s["name"] for r in recs for s in r["spans"]))
    for name in names:
        dev, host = per_request(recs, name, "device_ms"), per_request(recs, name, "host_ms")
        entries = sum(s["name"] == name for r in recs for s in r["spans"]) / len(recs)
        print(f"[program span] {name} device {dev!r} ms host {host!r} ms a request, "
              f"{entries!r} entries, {len(recs)} requests", file=sys.stderr, flush=True)
    sites = collections.Counter()
    for r in recs:
        sites.update(r["syncs"])
    for site, n in sites.most_common():
        print(f"[host sync] {site} {n / len(recs)!r} a request", file=sys.stderr, flush=True)


def span_ms(run, name: str) -> Optional[float]:
    """Device-stream ms a request inside the spans named `name` (their
    entries summed), the idle gaps inside them included."""
    recs = window(run)
    return None if not recs else per_request(recs, name, "device_ms")


def host_syncs(run) -> Optional[float]:
    """Host syncs a request, every site's counted together."""
    recs = window(run)
    return None if not recs else statistics.fmean(sum(r["syncs"].values()) for r in recs)
