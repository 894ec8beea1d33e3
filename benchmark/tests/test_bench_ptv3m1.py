"""The serve.512.ptv3m1 cell's parts on the CPU at the port's tiny profile:
the harness's run with the PT-v3m1 refiner, whose plain reference agrees
with the port and whose control does not (the refine offsets and the
gaussians from the program's offsets, the check split at the refiner), the refiner's calls logged for
kernel SC's bound, and SC's work function by hand."""

import importlib.util
import os
import time

from benchmark.harness import HERE, load_reader, run_cell
from benchmark.reference.plain_avatar.ops.calls import record
from benchmark.tests.tiny import CPU, tiny_cell


def tiny_ptv3m1_run(seed=2 ** 31 + 7):
    cell = tiny_cell("serve.512.ptv3m1", "s2_serve_ptv3m1", "stream2_512_ptv3m1",
                     warmup_requests=1, image_size=[32, 32])
    model = cell.config["model"]
    model.pop("ptv3_form")              # the tiny profile's, from the port's fields
    model["ptv3_output_dim"] = model["ptv3_dec_channels"][0]
    readers = {n: load_reader(n) for n in ("setup_s", "peak_mem_gib")}
    return run_cell(cell, seed, 1.0, False, CPU, readers, time.perf_counter(), control=True)


def test_ptv3m1_cell_correct_and_control_not():
    out = tiny_ptv3m1_run()
    assert out["correct"], out["checks"]
    gaps = {k: v["value"] for k, v in out["checks"].items()}
    assert set(gaps) == {"tri", "smpl", "pred", "gaussians", "frames", "offsets"}
    assert 0 < gaps["offsets"] and out["control"]["offsets"] > 3 * gaps["offsets"]
    assert out["control"]["gaussians"] > 3 * gaps["gaussians"]


def sc_metric():
    path = os.path.join(HERE, "metrics", "SC_roofline.serve.py")
    spec = importlib.util.spec_from_file_location("sc_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_subm_conv_work_by_hand():
    calls = [{"x": (10, 64), "nbr": (10, 27), "weight": (32, 3, 3, 3, 64), "bias": (32,),
              "pairs": 100}]
    flops, nbytes = sc_metric().subm_conv_work(calls)
    assert flops == 2 * 100 * 64 * 32
    assert nbytes == 2 * (10 * 64 + 10 * 32 + 27 * 64 * 32) + 4 * 10 * 27


def test_subm_conv_logged():
    import torch

    from benchmark.reference.plain_ptv3m1 import PlainSubMConv

    conv = PlainSubMConv(4, 8, 3, True)
    torch.nn.init.normal_(conv.weight)
    nbr = torch.tensor([[0, -1] + [-1] * 25, [1, 0] + [-1] * 25])
    with record() as log:
        y = conv(torch.randn(2, 4), nbr)
    assert y.shape == (2, 8)
    (call,) = log["subm_conv"]
    assert call["pairs"] == 3 and call["nbr"] == (2, 27) and call["weight"] == (8, 3, 3, 3, 4)


def test_subm_conv_logged_over_voxels():
    """Rows that share a voxel are one voxel of the map and of the logged
    work: 5 rows in 3 voxels, the two rows of a voxel the same output."""
    import torch

    from benchmark.reference.plain_ptv3m1 import PlainSubMConv, neighbours

    grid = torch.tensor([[0, 0, 0], [0, 0, 1], [0, 0, 0], [5, 5, 5], [0, 0, 1]])
    batch = torch.zeros(5, dtype=torch.int64)
    nbr, voxel = neighbours(batch, grid, torch.arange(5), 3, 3)
    assert nbr.shape == (3, 27) and int((nbr >= 0).sum()) == 5
    conv = PlainSubMConv(4, 8, 3, False)
    torch.nn.init.normal_(conv.weight)
    with record() as log:
        y = conv(torch.randn(5, 4), nbr, voxel)
    (call,) = log["subm_conv"]
    assert call["nbr"] == (3, 27) and call["pairs"] == 5
    assert torch.equal(y[0], y[2]) and torch.equal(y[1], y[4])
