"""Serving CLI of the port: the continuous-batching engine on one device.

Port of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --weights q4 --requests 8 --temperature 0.8 --top-k 40

serves the full-size config on ``cuda`` with random weights from seed 0
(``--reduced --device cpu`` runs the same path at CPU scale). The flags are
the reference's, plus ``--reduced``, ``--device`` and ``--s-max`` (the
cache's slots per sequence). Each request's prompt is ``[1 + i, 2 + i]``, as
in the reference; ``main`` also takes a list of ``Request``s to serve
instead, and returns its results (tokens, times, weight bytes, peak memory).
It serves token decoders only: whisper-large-v3 and qwen2-vl-2b are refused,
as the reference's CLI refuses them (they serve through ``models.prefill``
and ``models.decode_step``).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.models import init_model, named_params
from repro_torch.serve import Request, ServeEngine, format_weight_table

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config of the same family")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--weights", default="bf16", choices=("bf16", "q4"),
                    help="serving weight format (q4 = 4-bit block-quantized)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples on the device")
    ap.add_argument("--top-k", type=int, default=0, help="0 = full vocab")
    ap.add_argument("--seed", type=int, default=0, help="sampling stream seed")
    ap.add_argument("--drain-every", type=int, default=8, help="decode steps per host sync")
    ap.add_argument("--s-max", type=int, default=256, help="cache slots per sequence")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, requests: Optional[List[Request]] = None) -> Dict:
    """Run the CLI; ``requests`` replaces the CLI's own prompts. Returns the
    served requests, wall time, weight report and peak device memory."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "encdec" or cfg.input_mode == "embeds":
        raise SystemExit(f"{args.arch}: token-decoder archs only in this CLI")
    model = init_model(cfg, seed=0, device=device)
    masters = {k: p.detach() for k, p in named_params(model).items()}
    del model
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    eng = ServeEngine(cfg, masters, max_batch=args.max_batch, s_max=args.s_max,
                      weights=args.weights, drain_every=args.drain_every, seed=args.seed)
    del masters  # the engine holds the serving format only, as a server would
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mode = "greedy" if args.temperature <= 0 else f"T={args.temperature} top_k={args.top_k}"
    if requests is None:
        requests = [Request(rid=i, prompt=[1 + i, 2 + i], max_new_tokens=args.max_new_tokens,
                            temperature=args.temperature, top_k=args.top_k)
                    for i in range(args.requests)]
    else:
        mode = "the caller's requests"
    for r in requests:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    report = eng.weight_bytes()
    total_tokens = sum(len(r.output) for r in requests)
    print(format_weight_table([report], title="serving weights"))
    print(f"served {len(requests)} requests / {total_tokens} tokens in {wall:.2f}s on {device} "
          f"({mode}, drain_every={args.drain_every}, {total_tokens / wall:.1f} tok/s)")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"arch": cfg.name, "weights": args.weights, "requests": requests, "wall_s": wall,
            "tokens": total_tokens, "weight_report": report, "peak_bytes": peak,
            "materialize_calls": dict(eng.materialize_calls), "engine": eng}


if __name__ == "__main__":
    main()
