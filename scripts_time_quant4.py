"""Time the block-wise 4-bit quantize kernel (B2) of this tree against another
version of its source, in turns, on one CUDA card.

    python3 scripts_time_quant4.py --baseline path/to/other/quant4.cu

Both sources are built with the port's flags (``kernels/build.py``, one
``nvcc`` each, started together) and launched through the same binding
(``kernels/quant4.py``: ``bind``, ``quantize_into``). At every q4 leaf shape
of internlm2-1.8b (the quantized leaves of ``weight_report``, in the (R, C)
view ``kernel_view`` gives the kernel), from fp32 and from bf16 input, the two
must give the same codes and scales on finite data; then each is timed by
both methods of ``kernels/timing.py`` (one launch per event pair, median of
21; 20 back-to-back launches, median of 5; 3 warm-ups first) in the order
baseline, this tree, this tree, baseline. The per-tree sums of each turn are
printed with the card's name and power limit, and the table goes to
``chiprun_out/quant4_ab.json``. Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TURNS = ("baseline", "tree", "tree", "baseline")
METHODS = ("event_ms", "per_launch_ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True, help="the other quant4.cu")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("scripts_time_quant4: no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, quant4, timing
    from repro_torch.models import init_model, named_params
    from repro_torch.serve.weights import WEIGHT_Q4, kernel_view, weight_report

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    paths = build.build_libraries(args.baseline.resolve(), quant4.SOURCE)
    libs = {name: quant4.bind(ctypes.CDLL(str(path)))
            for name, path in zip(("baseline", "tree"), paths)}
    meta = named_params(init_model(get_config("internlm2-1.8b"), device="meta"))
    leaves = Counter(r["shape"] for r in weight_report(meta, "q4")["leaves"] if r["quantized"])

    dev = torch.device("cuda", 0)
    table = build.host_table(WEIGHT_Q4.table("cpu"))
    rows = []
    for shape, count in leaves.items():
        R, C = kernel_view(shape)
        g = torch.Generator(device=dev).manual_seed(R + C)
        x32 = torch.randn((R, C), generator=g, device=dev) * 0.02
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            calls, outs = {}, {}
            for name, lib in libs.items():
                codes = torch.empty((R, C // 2), dtype=torch.uint8, device=dev)
                scale = torch.empty((R, C // 128), dtype=torch.float32, device=dev)
                calls[name] = (lambda lib=lib, codes=codes, scale=scale:
                               quant4.quantize_into(lib, x, codes, scale, table))
                if calls[name]() != 0:
                    sys.exit(f"scripts_time_quant4: {name} launch failed")
                outs[name] = (codes, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs["baseline"], outs["tree"])):
                sys.exit(f"scripts_time_quant4: {shape} {dtype}: the two builds disagree")
            row = dict(shape=list(shape), view=[R, C], count=count, dtype=str(dtype))
            for method in METHODS:
                row[method] = []
                for name in TURNS:
                    for _ in range(3):
                        calls[name]()
                    row[method].append(getattr(timing, method)(calls[name]))
            rows.append(row)
            print(f"{shape} as ({R}, {C}) x{count} {dtype}: " + "; ".join(
                f"{method} " + ", ".join(f"{t} {m:.4f}" for t, m in zip(TURNS, row[method]))
                for method in METHODS) + " ms")
            del x, calls, outs
        del x32
        torch.cuda.empty_cache()
    tree = {}
    for dtype in ("torch.float32", "torch.bfloat16"):
        for method in METHODS:
            sums = [sum(r[method][k] * r["count"] for r in rows if r["dtype"] == dtype)
                    for k in range(len(TURNS))]
            tree[f"{dtype} {method}"] = dict(zip(("baseline_1", "tree_1", "tree_2", "baseline_2"),
                                                 sums))
            base, new = (sums[0] + sums[3]) / 2, (sums[1] + sums[2]) / 2
            print(f"tree {dtype} {method}: "
                  + ", ".join(f"{t} {m:.4f}" for t, m in zip(TURNS, sums))
                  + f" ms; this tree {new:.4f} ms against {base:.4f} ms ({new / base - 1:+.1%})")
    print(f"card: {card}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "quant4_ab.json").write_text(json.dumps(
        {"card": card, "baseline": str(args.baseline), "turns": TURNS, "leaves": len(rows) // 2,
         "rows": rows, "tree": tree}, indent=1))


if __name__ == "__main__":
    main()
