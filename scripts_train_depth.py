"""Peak device memory of the port's training or q4 serving CLI at several
depths of one arch.

    python3 scripts_train_depth.py --arch chatglm3-6b --layers 4,8,9,10 [--steps 5]
    python3 scripts_train_depth.py --serve --arch mixtral-8x7b --layers 10,11,12

Training runs ``repro_torch.launch.train`` (production4bit, SR seed 0, batch 8
x seq 128, on the card); ``--serve`` runs ``repro_torch.launch.serve`` with
q4 weights on the serving mix of ``chip_smoke.py`` (8 requests, prompts of
32-384 tokens from seed 0, half greedy and half sampled, 64 new tokens each,
4 slots, 1024 cache slots, 8 decode steps per host sync). Either runs at
full width with the config cut to its first ``L`` layers, once per depth,
each in a fresh process, and prints one JSON line a depth: the peak
allocated and reserved bytes and the step times (serving: tok/s), or the
out-of-memory error that ended it. Then the peak's growth a layer between
the two deepest depths that fit, and the depth where that line crosses the
card's memory. The runs use the caching allocator's expandable segments,
as ``chip_smoke.py`` does, unless ``PYTORCH_CUDA_ALLOC_CONF`` is set. Needs
a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _cut(module, layers: int) -> None:
    """Make ``module.get_config`` give the config cut to its first layers."""
    from repro_torch.configs import cut_depth

    real = module.get_config
    module.get_config = lambda name: cut_depth(real(name), layers)


def _serve_requests(vocab: int):
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lengths = rng.integers(32, 385, size=8)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(n)).tolist(),
                    max_new_tokens=64, **({} if i % 2 == 0 else dict(temperature=0.8, top_k=40)))
            for i, n in enumerate(lengths)]


def _one(arch: str, layers: int, steps: int, serve: bool) -> dict:
    import torch

    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train

    module = serve_cli if serve else train
    _cut(module, layers)
    row = dict(arch=arch, layers=layers, mode="serve-q4" if serve else "train")
    try:
        if serve:
            reqs = _serve_requests(module.get_config(arch).vocab_size)
            out = serve_cli.main(["--arch", arch, "--weights", "q4", "--max-batch", "4",
                                  "--max-new-tokens", "64", "--drain-every", "8", "--s-max",
                                  "1024", "--seed", "0", "--device", "cuda"], requests=reqs)
            row.update(weight_bytes=out["weight_report"]["total_serve_bytes"],
                       tok_per_s=out["tokens"] / out["wall_s"])
        else:
            out = train.main(["--arch", arch, "--optimizer", "production4bit", "--sr-seed", "0",
                              "--steps", str(steps), "--batch", "8", "--seq", "128",
                              "--device", "cuda"])
            row.update(state_bytes=out["state_bytes"], step_ms=[r["ms"] for r in out["steps"]])
    except torch.OutOfMemoryError as e:
        return dict(row, fits=False, error=str(e).split(". If")[0],
                    reserved_bytes=torch.cuda.max_memory_reserved())
    return dict(row, fits=True, peak_bytes=out["peak_bytes"],
                reserved_bytes=torch.cuda.max_memory_reserved(),
                total_bytes=torch.cuda.get_device_properties(0).total_memory)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", required=True, help="comma-separated depths")
    ap.add_argument("--steps", type=int, default=5, help="training steps a depth")
    ap.add_argument("--serve", action="store_true", help="q4 serving instead of training")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        sys.exit("scripts_train_depth.py: no CUDA device")
    if args.one:
        row = _one(args.arch, int(args.layers), args.steps, args.serve)
        print("RESULT " + json.dumps(row))
        return
    rows = []
    for layers in (int(x) for x in args.layers.split(",")):
        run = subprocess.run([sys.executable, __file__, "--one", "--arch", args.arch, "--layers",
                              str(layers), "--steps", str(args.steps)]
                             + (["--serve"] if args.serve else []),
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
        print(f"{args.arch} ({b['mode']}): peak grows {per_layer / 1e9:.3f} GB a layer between "
              f"{a['layers']} and {b['layers']} layers; the line reaches the card's "
              f"{b['total_bytes'] / 1e9:.1f} GB at {cross:.1f} layers")


if __name__ == "__main__":
    main()
