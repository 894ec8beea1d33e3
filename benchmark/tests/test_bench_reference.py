"""The harness's run on the CPU at the port's tiny profile: the plain
reference agrees with the port, the control does not, and the result
carries the contract's keys."""

import subprocess
import sys
import time

import pytest

from benchmark.harness import ROOT, load_reader, run_cell
from benchmark.tests.tiny import CPU, tiny_cell

SERVE = ("serve.512", "s2_serve", "stream2_512", dict(image_size=[32, 32]))
RECON = ("recon.1024", "s1_recon", "recon1_1024", dict(image_size=[64, 64], novel_views=2))


def tiny_run(spec, control=False, seed=2 ** 31 + 5, **traffic):
    workload, config, trf, over = spec
    cell = tiny_cell(workload, config, trf, warmup_requests=1, **dict(over, **traffic))
    readers = {n: load_reader(n) for n in ("setup_s", "peak_mem_gib")}
    return run_cell(cell, seed, 1.0, False, CPU, readers, time.perf_counter(), control=control)


@pytest.fixture(scope="module")
def serve_run():
    return tiny_run(SERVE, control=True)


@pytest.fixture(scope="module")
def recon_run():
    return tiny_run(RECON, control=True)


def test_serve_reference_agrees_with_the_port(serve_run):
    # the same modules in fp32 on the CPU, the port's kernels' plain versions
    assert serve_run["correct"]
    assert all(c["value"] <= 1e-5 for c in serve_run["checks"].values()), serve_run["checks"]


def test_recon_reference_agrees_with_the_port(recon_run):
    # the port's ViT computes in bf16 whatever the config says; the rest fp32
    assert recon_run["correct"]
    assert all(c["value"] <= 2e-2 for c in recon_run["checks"].values()), recon_run["checks"]


@pytest.mark.parametrize("run", ["serve_run", "recon_run"])
def test_control_reads_far_above_the_program(run, request):
    out = request.getfixturevalue(run)
    worst_ratio = max(out["control"][k] / max(c["value"], 1e-7) for k, c in out["checks"].items())
    assert worst_ratio >= 3.0, (out["control"], out["checks"])


def test_result_keys(serve_run):
    assert list(serve_run)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(serve_run)[-1] == "checks"
    assert serve_run["attempted"] >= 1 and serve_run["failed"] == 0
    for m in serve_run["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "serve.512",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
