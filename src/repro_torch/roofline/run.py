"""Roofline sweep: every runnable cell on the single-pod mesh (port of
``repro/roofline/run.py``), counted on the ``meta`` device with the H100's
constants; no process and no device needed.

    python -m repro_torch.roofline.run --arch xlstm-125m --shape train_4k
    python -m repro_torch.roofline.run --all --out results/roofline.json
"""

from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable
from repro_torch.launch.dryrun import MESHES
from repro_torch.roofline.measured import measure_cell

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/roofline.json")
    ap.add_argument("--order", default=None, help="comma-separated arch order")
    args = ap.parse_args(argv)

    mesh = MESHES["single"]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        rec = measure_cell(args.arch, args.shape, mesh)
        print(json.dumps(rec, indent=1, default=str))
        return rec

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"]) for r in results}
    archs = args.order.split(",") if args.order else list(ARCHS)
    for arch in archs:
        for shape_name in SHAPES:
            if (arch, shape_name) in done:
                continue
            runnable, reason = cell_is_runnable(arch, shape_name)
            if not runnable:
                results.append({"arch": arch, "shape": shape_name,
                                "status": "skipped", "reason": reason})
                continue
            print(f"=== roofline {arch} x {shape_name} ===", flush=True)
            try:
                rec = measure_cell(arch, shape_name, mesh)
                rec["status"] = "ok"
            except Exception as e:
                rec = {"arch": arch, "shape": shape_name, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-1500:]}
                print(rec["error"], flush=True)
            results.append(rec)
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    print("ROOFLINE SWEEP COMPLETE")
    return results


if __name__ == "__main__":
    main()
