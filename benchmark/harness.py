"""One run of one cell: find its files by name, set up, measure, check,
print the result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration,
`configs/<config>.json`, and a traffic mix, `traffic/<traffic>.json`,
whose `driver` names the module in `drivers/` that generates it. Its
comparison limits are `limits/<workload>.json`. Each metric of
BENCHMARK.json that the cell reports is read by `metrics/<name>.py`. So a
later change adds a configuration, a cell or a metric by adding files.

A run: set-up (build, warm-up; `setup_s` from the process's start), the
measured window, with `--trace 1` a profiled slice after it, then the
program is freed and the sampled requests are held against the plain
reference. The result is the last line of standard output; the compared
numbers, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics this cell reports in this mode, as BENCHMARK.json lists
    them (a metric without `workloads` is every cell's)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    """metrics/<name>.py as a module (names hold dots, so by path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """What one cell runs: its name, its configuration and traffic files'
    contents and its limits."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int = 1

    @classmethod
    def from_files(cls, bench: dict, workload: str) -> "Cell":
        entry = find_cell(bench, workload)
        return cls(workload, load_json(HERE, "configs", f"{entry['config']}.json"),
                   load_json(HERE, "traffic", f"{entry['traffic']}.json"),
                   load_json(HERE, "limits", f"{workload}.json"), entry["chips"])


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""
    setup_s: float
    window_s: float
    latencies_s: List[float]
    frames: int
    peak_mem_bytes: int
    spans_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    slice: object = None                 # tracing.Slice of the profiled requests
    calls: Dict[str, list] = dataclasses.field(default_factory=dict)   # one request's
    flops_per_request: Optional[float] = None
    elem_bytes: int = 2

    @property
    def requests(self) -> int:
        return len(self.latencies_s)


def p90(values) -> float:
    """The 90th percentile of all values (statistics.quantiles, inclusive)."""
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             readers: Dict[str, object], t_start: float, control: bool = False) -> dict:
    """Set up, measure, check; the result's fields (without `device`)."""
    import torch

    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    drv = driver.Driver(cell, seed, device)
    before = time.perf_counter() - t_start
    drv.setup()
    setup_s = time.perf_counter() - t_start
    say(f"[setup] {setup_s:.3f} s (process start to set-up {before:.3f} s, {drv.setup_parts()})")

    spans = None
    if trace:
        from .tracing import Spans
        paths = sorted({p for r in readers.values() for p in getattr(r, "SPANS", ())})
        spans = Spans(drv.system, paths) if paths else None
    win = drv.window(seconds, spans)
    run = Run(setup_s, win["window_s"], win["latencies_s"], win["frames"], win["peak_mem_bytes"],
              elem_bytes=drv.elem_bytes)
    lat_ms = [1e3 * s for s in run.latencies_s]
    half = max(1, len(lat_ms) // 2)
    say(f"[window] {run.requests} requests in {run.window_s:.3f} s, latency median "
        f"{statistics.median(lat_ms):.3f} ms, min {min(lat_ms):.3f}, max {max(lat_ms):.3f}, "
        f"mean of the first and second half {statistics.mean(lat_ms[:half]):.3f} / "
        f"{statistics.mean(lat_ms[half:] or lat_ms):.3f} ms; {run.frames} frames; "
        f"peak {run.peak_mem_bytes} bytes")
    if spans is not None:
        torch.cuda.synchronize()
        run.spans_ms = spans.total_ms()
        spans.remove()
    if trace:
        from .tracing import profile
        t = time.perf_counter()
        run.slice = profile(drv.run_requests, cell.traffic["profile_requests"])
        say(f"[profile] {time.perf_counter() - t:.3f} s" + (
            "" if run.slice is None else f", busy {run.slice.busy_s:.6f} s of "
            f"{run.slice.wall_s:.6f} s, {run.slice.launches} launches"))
        if run.slice is not None:
            for name, s in run.slice.breakdown(top=40, name_chars=120)["device_ops"]:
                say(f"[device op] {s!r} s {name}")
    drv.release()
    t = time.perf_counter()
    checked = drv.check(count_work=trace, control=control)
    say(f"[reference] {time.perf_counter() - t:.3f} s for {len(drv.samples)} requests "
        f"({', '.join(str(s['index']) for s in drv.samples)})")
    gaps = checked["gaps"]
    run.calls, run.flops_per_request = checked.get("calls", {}), checked.get("flops")

    metrics = {}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    correct = all(v <= limits[k] for k, v in gaps.items()) and set(gaps) == set(limits)
    out = {"correct": correct, "attempted": run.requests, "failed": 0, "metrics": metrics,
           "peak_mem_bytes": run.peak_mem_bytes}
    if control:
        out["control"] = checked["control_gaps"]
        for k, v in out["control"].items():
            say(f"[control] {k} {v!r} limit {limits[k]!r}")
    if trace and run.slice is not None:
        out["busy_s"], out["window_s"] = run.slice.busy_s, run.slice.wall_s
        out["breakdown"] = run.slice.breakdown()
    out["checks"] = checks
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the lower-precision control's numbers (limit setting)")
    args = ap.parse_args(argv)

    from .chip import NoCard, card_info, forbidden_loaded, require_cards

    bench = load_json(ROOT, "BENCHMARK.json")
    cell = Cell.from_files(bench, args.workload)
    try:
        require_cards(cell.chips)
    except NoCard as e:
        say(f"[no card] {e}")
        return 2
    import torch

    info = card_info(0)
    say(f"[card] {torch.cuda.get_device_name(0)}, power limit {info['power.limit']}, "
        f"SM clock {info['clocks.sm']}, temperature {info['temperature.gpu']}")
    readers = {m["name"]: load_reader(m["name"])
               for m in cell_metrics(bench, args.workload, bool(args.trace))}
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   readers, t_start, control=args.control)
    found = forbidden_loaded()
    if found:
        say(f"[refused] the process holds {', '.join(found)}")
        return 3
    checks = out.pop("checks")
    info = card_info(0)
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                     "memory_peak_bytes": out.pop("peak_mem_bytes"),
                     "power_limit": info["power.limit"], "sm_clock": info["clocks.sm"],
                     "temperature": info["temperature.gpu"],
                     **{k: out.pop(k) for k in ("busy_s", "window_s") if k in out}}
    out["checks"] = {k: [v["value"], v["limit"]] for k, v in checks.items()}
    for k, v in checks.items():
        say(f"[check] {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
