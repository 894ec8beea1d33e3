"""Spans from the benchmark's own hooks, and the reduction of a profiler
slice to device time, launches, idle gaps and kernel times.

A span records a CUDA event when a module of the built system is entered
and another when it returns (forward hooks; nothing inside the program is
edited), with no synchronize between: the events are read once the window
has closed.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional

import torch


def resolve(root, path: str):
    """'model.audio_triplane' -> that attribute of `root`."""
    obj = root
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


class Spans:
    """CUDA-event spans around modules of `root`, by dotted path."""

    def __init__(self, root, paths: Iterable[str]):
        self.events: Dict[str, List[tuple]] = {p: [] for p in paths}
        self.handles = []
        self.on = False
        for path in self.events:
            module = resolve(root, path)
            self.handles.append(module.register_forward_pre_hook(self._enter(path)))
            self.handles.append(module.register_forward_hook(self._exit(path)))

    def _enter(self, path):
        def hook(module, args):
            if self.on:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events[path].append((ev, None))
        return hook

    def _exit(self, path):
        def hook(module, args, out):
            if self.on:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                start, _ = self.events[path][-1]
                self.events[path][-1] = (start, ev)
        return hook

    def total_ms(self) -> Dict[str, float]:
        """Device milliseconds inside each span, summed over its calls
        (call after a synchronize)."""
        return {p: sum(a.elapsed_time(b) for a, b in evs)
                for p, evs in self.events.items()}

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def device_events(prof) -> list:
    """(name, start_us, end_us) of every device activity in a profiler run
    (kernels, copies, sets), by the profiler's clock."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def host_events(prof) -> list:
    """(name, start_us, end_us, depth) of the host's operations."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        depth, p = 0, e.cpu_parent
        while p is not None:
            depth, p = depth + 1, p.cpu_parent
        out.append((e.name, e.time_range.start, e.time_range.end, depth))
    return out


def union_intervals(intervals) -> list:
    """Merged (start, end) of possibly overlapping intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


class Slice:
    """What a profiled slice of `requests` requests shows: device busy
    seconds (the union of device activity), launches, seconds by kernel
    name, and the idle gaps named by what the host was doing."""

    def __init__(self, prof, requests: int, wall_s: float):
        dev = device_events(prof)
        self.requests = requests
        self.wall_s = wall_s
        merged = union_intervals([(a, b) for _, a, b in dev])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        self.launches = sum(1 for n, _, _ in dev if is_kernel(n))
        by_name = collections.defaultdict(float)
        for n, a, b in dev:
            by_name[n] += (b - a) * 1e-6
        self.kernel_s = dict(by_name)
        self.gaps = self._gaps(merged, host_events(prof))

    @staticmethod
    def _gaps(merged, host) -> Dict[str, float]:
        """Seconds of each gap between device activity, keyed by the
        deepest host operation running at the gap's midpoint."""
        named = collections.defaultdict(float)
        host = sorted(host, key=lambda h: h[1])
        active, i = [], 0
        for (_, a), (b, _) in zip(merged, merged[1:]):   # gaps in time order
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            name = max(active, key=lambda h: (h[3], h[1]))[0] if active else "(no host op)"
            named[name] += (b - a) * 1e-6
        return dict(named)

    def seconds(self, names: Iterable[str]) -> float:
        """Device seconds of the kernels whose name contains one of `names`."""
        names = tuple(names)
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def breakdown(self, top: int = 10, name_chars: int = 160) -> dict:
        """The device operations that took most time and the longest idle
        gaps by host operation, seconds over the slice (names cut short)."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:name_chars], s] for n, s in ops],
                "idle_gaps": [[n[:name_chars], s] for n, s in gaps]}


def profile(run_requests, requests: int) -> Optional[Slice]:
    """Run `run_requests(requests)` under torch.profiler (host and device)
    and reduce it; None where the profiler recorded no device activity."""
    import time

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_requests(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sl = Slice(prof, requests, wall)
    return sl if sl.busy_s > 0 else None
