"""Training CLI of the port: --arch <id> [--reduced] --steps N.

Port of ``repro/launch/train.py`` for one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --optimizer production4bit --sr-seed 0 --steps 5

runs on ``cuda`` (``--device cpu --reduced`` runs the same path at CPU
scale). The flags are the reference's; ``--mesh``, ``--grad-comm`` other than
fp32 and ``--ckpt-dir`` are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import ast
import time
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core.optimizers import (
    linear_warmup_linear_decay,
    make_optimizer,
    optimizer_names,
    state_nbytes,
)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import sr
from repro_torch.models import init_model
from repro_torch.train.train_loop import build_train_step, make_train_state

__all__ = ["main", "parse_args"]


def _parse_value(v: str):
    """--opt-arg value: bool words, then any Python literal, else the string."""
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config of the same family")
    ap.add_argument("--optimizer", default="adamw4bit", choices=list(optimizer_names()))
    ap.add_argument("--opt-arg", action="append", default=[], metavar="K=V",
                    help="optimizer override, e.g. --opt-arg use_kernel=false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sr-seed", type=int, default=None,
                    help="seed of the stochastic-rounding key stream (omit for round-to-nearest)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--grad-comm", default="fp32", help="only fp32 in the port so far")
    ap.add_argument("--mesh", default=None, help="not ported yet")
    ap.add_argument("--ckpt-dir", default=None, help="not ported yet")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        ap.error("--mesh: the port runs on one device; the mesh path is not ported yet")
    if args.grad_comm != "fp32":
        ap.error("--grad-comm: only fp32 (no gradient collective on one device) is ported")
    if args.ckpt_dir is not None:
        ap.error("--ckpt-dir: checkpoints are not ported yet")
    for kv in args.opt_arg:
        if "=" not in kv:
            ap.error(f"--opt-arg {kv!r}: expected K=V (e.g. use_kernel=true)")
    return args


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns a summary (per-step loss and ms, state bytes,
    peak device memory) for callers such as ``chip_smoke.py``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    overrides = {k: _parse_value(v) for k, _, v in (kv.partition("=") for kv in args.opt_arg)}
    opt = make_optimizer(
        args.optimizer,
        linear_warmup_linear_decay(args.lr, max(1, args.steps // 10), args.steps),
        **overrides,
    )
    sr_key = sr.PRNGKey(args.sr_seed) if args.sr_seed is not None else None

    model = init_model(cfg, seed=0, device=device)
    state = make_train_state(model, opt, key=sr_key)
    nbytes = state_nbytes(state.opt_state)
    n_params = sum(p.numel() for p in state.params.values())
    print(f"arch={cfg.name} params={n_params:,} optimizer={opt.name} "
          f"state_bytes={nbytes:,} device={device}")

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    step_fn = build_train_step(model, opt)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    for t in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(t).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        records.append({"step": t, "loss": loss, "ms": ms,
                        "grad_norm": float(metrics["grad_norm"])})
        if t % 5 == 0:
            print(f"step {t:4d} loss {loss:.4f} ({ms:.0f} ms)")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"arch": cfg.name, "optimizer": opt.name, "state_bytes": nbytes,
            "n_params": n_params, "steps": records, "peak_bytes": peak, "state": state}


if __name__ == "__main__":
    main()
