"""program_trace.window picks the window's records out of a run's
warm-up, window and profiled requests, and the readers fall silent where
the port has no tracer or the ring kept too few requests (CPU)."""

import types

import pytest

from audio_motion_avatar_tpu_torch.utils import profiling
from benchmark import program_trace


def fake_run(window, profiled):
    sl = None if profiled is None else types.SimpleNamespace(requests=profiled)
    return types.SimpleNamespace(requests=window, slice=sl)


@pytest.fixture
def tracer():
    """The port's tracer on with an empty ring, restored afterwards."""
    was = profiling.TRACER.on
    profiling.enable()
    profiling.reset()
    yield profiling
    profiling.reset()
    profiling.TRACER.on = was


def serve_requests(phase, n, syncs):
    for _ in range(n):
        with profiling.request("serve.request", "cpu"):
            with profiling.span(phase):
                pass
            for _ in range(syncs):
                with profiling.host_sync("site"):
                    pass


def test_window_picks_the_window_records(tracer):
    serve_requests("warmup", 2, 1)
    serve_requests("window", 3, 2)
    serve_requests("profiled", 2, 5)
    recs = program_trace.window(fake_run(3, 2))
    assert [r["spans"][1]["name"] for r in recs] == ["window"] * 3
    assert [r["id"] for r in recs] == sorted(r["id"] for r in recs)
    assert program_trace.host_syncs(fake_run(3, 2)) == 2.0


def test_pick_by_position():
    recs = [{"id": i} for i in range(7)]
    assert [r["id"] for r in program_trace.pick(recs, 3, 2)] == [2, 3, 4]
    assert [r["id"] for r in program_trace.pick(recs, 5, 2)] == [0, 1, 2, 3, 4]
    assert program_trace.pick(recs, 6, 2) is None


@pytest.mark.parametrize("run", [fake_run(3, 2), fake_run(3, None)], ids=["too few", "no slice"])
def test_window_none(tracer, run):
    serve_requests("window", 4, 0)
    assert program_trace.window(run) is None
    assert program_trace.span_ms(run, "window") is None
    assert program_trace.host_syncs(run) is None


def test_span_sums_entries_and_mean(monkeypatch):
    def rec(ms):
        return {"syncs": {"a": 1, "b": 2},
                "spans": [{"name": "s", "device_ms": v, "host_ms": 0.5} for v in ms]}
    recs = [rec([1.0, 2.0]), rec([3.0]), rec([1.0])]     # 1 warm-up, 2 window
    monkeypatch.setattr(profiling, "records", lambda: recs + [rec([9.0])])
    run = fake_run(2, 1)
    assert program_trace.span_ms(run, "s") == 2.0
    assert program_trace.span_ms(run, "missing") is None
    assert program_trace.host_syncs(run) == 3.0


def test_cpu_records_have_no_device_time(tracer):
    serve_requests("window", 3, 0)
    assert program_trace.span_ms(fake_run(2, 1), "window") is None


def test_parent_tree_without_tracer(monkeypatch):
    monkeypatch.setattr(program_trace, "TRACING", False)
    run = fake_run(1, 1)
    assert program_trace.window(run) is None and program_trace.host_syncs(run) is None
