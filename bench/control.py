"""The readings that set a cell's limits: the program's, the control's and
the planted faults', each against the reference, over several seeds in one
process.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 [--program] [--control]

For each seed, one JSON line of gaps (``check.gaps``) against the reference
following the cell's checked steps:

* ``program`` (``--program``): the program's checked steps, as a run takes
  them;
* ``control`` (``--control``): the reference itself with every weight
  product's operands rounded to fp8 (``reference.model``), the step below
  the configuration's bf16;
* ``half_batch`` (``--control``): the reference on half of every batch
  (half of the rows, or of the positions of a one-row batch), the mean over
  the rest.

A step that returns its state unchanged reads 1 by the change's measure and
needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import torch  # noqa: E402

import check  # noqa: E402
import harness  # noqa: E402
import traffic as traffic_lib  # noqa: E402


def program_readings(cell, ring, seed: int, device) -> dict:
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in ring]
    prog = harness.Program(cell, seed, device)
    out = harness.checked_steps(cell, prog, batches, seed, device)
    out["losses"] = [float(x) for x in out["losses"]]
    del prog, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def half(traffic: dict) -> slice:
    return (slice(0, traffic["batch"] // 2), slice(None)) if traffic["batch"] > 1 else (
        slice(None), slice(0, traffic["seq"] // 2))


def main(argv=None, *, bench_file=None, data: Path = BENCH, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload, bench_file or BENCH.parent / "BENCHMARK.json", data)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    steps = cell.workload["check_steps"]
    for seed in (int(s) for s in args.seeds.split(",")):
        ring = traffic_lib.ring(cell.traffic, cell.config["vocab_size"], seed)
        row = {"seed": seed}
        t0 = time.perf_counter()
        prog = program_readings(cell, ring, seed, dev) if args.program else None
        ref = check.follow(cell.config, cell.workload, ring, seed, dev, steps)
        if prog is not None:
            row["program"] = check.gaps(prog, ref)
        if args.control:
            row["control"] = check.gaps(
                check.follow(cell.config, cell.workload, ring, seed, dev, steps, rounding="fp8"),
                ref)
            row["half_batch"] = check.gaps(
                check.follow(cell.config, cell.workload, ring, seed, dev, steps,
                             part=half(cell.traffic)), ref)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
