"""On the card, at each cell's own size: a run of the program is correct,
and the lower-precision control, read on the same sampled requests, is
not (it fails at least one of the cell's limits). About a minute a cell:

    python -m pytest benchmark/tests/test_bench_gpu.py -q -m gpu
"""

import time

import pytest

from benchmark.harness import ROOT, Cell, load_json, run_cell

pytestmark = pytest.mark.gpu
BENCH = load_json(ROOT, "BENCHMARK.json")


@pytest.mark.parametrize("workload", [c["name"] for c in BENCH["workloads"]])
def test_program_correct_control_not(workload, cuda):
    cell = Cell.from_files(BENCH, workload)
    out = run_cell(cell, 2 ** 31 + 4242, 5.0, False, cuda, {}, time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    limits = cell.limits["limits"]
    assert any(v > limits[k] for k, v in out["control"].items()), (out["control"], limits)
