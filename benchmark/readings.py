"""The readings a cell's limits are set from, many seeds in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 --seconds 5

For each seed, one run of the cell (set-up, a short window, the check)
with the lower-precision control read on the same sampled requests; one
JSON line a seed: the program's numbers, the control's and the run's
`correct` under the limits in force.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("OMP_NUM_THREADS", "1")


def main() -> int:
    import argparse

    import torch

    from benchmark.chip import require_cards
    from benchmark.harness import ROOT, Cell, load_json, run_cell

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    cell = Cell.from_files(load_json(ROOT, "BENCHMARK.json"), args.workload)
    require_cards(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), {}, t0,
                       control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "requests": out["attempted"],
                          "program": {k: v["value"] for k, v in out["checks"].items()},
                          "control": out["control"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
