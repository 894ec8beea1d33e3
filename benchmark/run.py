"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result; the numbers compared with
the reference, each beside its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT            # the checkout's root, not benchmark/, heads the path
os.environ.setdefault("USE_FLAX", "0")

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
