"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``harness`` says what a run does). The cells,
their configurations, traffic and metrics are named in ``BENCHMARK.json``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
# the allocator grows segments instead of splitting fixed ones: the MoE
# layers' gradient stacks otherwise leave tens of GB reserved but unusable
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
