"""Peak device memory of the port's training CLI at several depths of one arch.

    python3 scripts_train_depth.py --arch chatglm3-6b --layers 4,8,9,10 [--steps 5]

Runs ``repro_torch.launch.train`` (production4bit, SR seed 0, batch 8 x seq
128, on the card) at full width with the config cut to its first ``L``
layers, once per depth, each in a fresh process, and prints one JSON line a
depth: the peak allocated and reserved bytes and the step times, or the
out-of-memory error that ended it. Then the peak's growth a layer between
the two deepest depths that fit, and the depth where that line crosses the
card's memory. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _one(arch: str, layers: int, steps: int) -> dict:
    import torch

    from repro_torch.launch import train

    real = train.get_config
    train.get_config = lambda name: dataclasses.replace(
        real(name), num_layers=layers, blocks=real(name).blocks[:layers])
    args = ["--arch", arch, "--optimizer", "production4bit", "--sr-seed", "0", "--steps",
            str(steps), "--batch", "8", "--seq", "128", "--device", "cuda"]
    try:
        out = train.main(args)
    except torch.OutOfMemoryError as e:
        return dict(arch=arch, layers=layers, fits=False, error=str(e).split(". If")[0],
                    reserved_bytes=torch.cuda.max_memory_reserved())
    return dict(arch=arch, layers=layers, fits=True, peak_bytes=out["peak_bytes"],
                reserved_bytes=torch.cuda.max_memory_reserved(),
                state_bytes=out["state_bytes"], step_ms=[r["ms"] for r in out["steps"]],
                total_bytes=torch.cuda.get_device_properties(0).total_memory)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", required=True, help="comma-separated depths")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("scripts_train_depth.py: no CUDA device")
    if args.one:
        print("RESULT " + json.dumps(_one(args.arch, int(args.layers), args.steps)))
        return
    rows = []
    for layers in (int(x) for x in args.layers.split(",")):
        run = subprocess.run([sys.executable, __file__, "--one", "--arch", args.arch, "--layers",
                              str(layers), "--steps", str(args.steps)],
                             capture_output=True, text=True)
        line = [x for x in run.stdout.splitlines() if x.startswith("RESULT ")]
        if not line:
            sys.exit(f"depth {layers}: no result (rc {run.returncode}): {run.stderr[-2000:]}")
        row = json.loads(line[0][len("RESULT "):])
        print(json.dumps(row))
        rows.append(row)
    fit = [r for r in rows if r["fits"]]
    if len(fit) >= 2:
        a, b = fit[-2], fit[-1]
        per_layer = (b["peak_bytes"] - a["peak_bytes"]) / (b["layers"] - a["layers"])
        cross = b["layers"] + (b["total_bytes"] - b["peak_bytes"]) / per_layer
        print(f"{args.arch}: peak grows {per_layer / 1e9:.3f} GB a layer between {a['layers']} "
              f"and {b['layers']} layers; the line reaches the card's "
              f"{b['total_bytes'] / 1e9:.1f} GB at {cross:.1f} layers")


if __name__ == "__main__":
    main()
