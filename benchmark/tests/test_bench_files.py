"""Every configuration, cell, traffic, limit and metric file is found by
the name BENCHMARK.json gives it, parses, and keeps to the benchmark's
contract."""

import json
import os
import re

import pytest

from benchmark.harness import HERE, ROOT, Cell, cell_metrics, load_json, load_reader

BENCH = load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in BENCH[group]:
            assert set(entry) == keys, entry["name"]
            assert NAME.match(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in METRICS:
        allowed = {"name", "unit", "better", "source", "workloads"}
        if m in BENCH["end_to_end"]:
            allowed |= {"bound"}
        else:
            allowed |= {"layer", "moves"}
        assert set(m) <= allowed and NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    path = os.path.join(ROOT, entry["file"])
    cfg = load_json(path)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
    AvatarConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()})
    widths = [k for k in cfg["reduced"] if k.endswith(("_dim", "_rank")) or "size" in k]
    assert not widths


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files(workload):
    cell = Cell.from_files(BENCH, workload)
    assert os.path.exists(os.path.join(HERE, "drivers", f"{cell.traffic['driver']}.py"))
    e2e = {m["name"] for m in cell_metrics(BENCH, workload, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell_metrics(BENCH, workload, True)
    assert cell.chips == 1


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    reader = load_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    assert callable(reader.read)
    if metric in BENCH["per_layer"]:
        assert reader.LAYER == metric["layer"] and reader.MOVES == metric["moves"]
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moved = e2e[metric["moves"]]
        for w in metric["workloads"]:
            assert w in moved.get("workloads", CELLS)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_reference_computes_the_config(entry):
    from benchmark.reference.entry import avatar_config

    avatar_config(load_json(ROOT, entry["file"])["model"])


@pytest.mark.parametrize("knob,named", [(dict(rgb=False, sh_degree=1), "rgb"),
                                        (dict(upsample_triplane=False), "upsample_triplane"),
                                        (dict(upsampler_sparse_penultimate=True), "penultimate"),
                                        (dict(upsampler_sparse=True, sample_quad=False),
                                         "sample_quad")], ids=lambda k: str(k))
def test_reference_refuses_forms_it_does_not_compute(knob, named):
    from benchmark.reference.entry import avatar_config

    with pytest.raises(ValueError, match=named):
        avatar_config(dict(load_json(ROOT, BENCH["configs"][0]["file"])["model"], **knob))
