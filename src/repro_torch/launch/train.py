"""Training CLI of the port: --arch <id> [--reduced] --steps N.

Port of ``repro/launch/train.py`` for one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --optimizer production4bit --sr-seed 0 --steps 5

runs on ``cuda`` (``--device cpu --reduced`` runs the same path at CPU
scale). The flags are the reference's. ``--mesh DxM`` trains on a (data=D,
model=M) mesh of D*M local processes (``train_loop.build_train_step(mesh=)``):
they meet through a ``FileStore`` in a fresh directory (``--run-dir``, else
a new temporary one), never a fixed port. The backend is NCCL when each
rank has a card of its own and gloo on the CPU or when the ranks share a
card (the first line says which); under gloo the collectives copy CUDA
tensors through host memory; it also counts the leaves that compute
tensor-parallel on the model axis (heads or rows, mlp columns, vocab rows
or width columns: ``sharding.tensor_parallel``) and those gathered whole. Rank 0 prints the
step lines and every rank's
state, parameter and peak bytes and checkpoint times. The modality-stub
archs (whisper-large-v3, qwen2-vl-2b) are refused, as the reference's CLI
refuses them: they train through the library
(``train_loop.build_train_step``). ``--grad-comm {fp32,bf16,int8,int4}`` applies the gradient wire
format on the one device (int8/int4: block-quantized transport with
stochastic rounding keyed off the ``--sr-seed`` stream).

With ``--ckpt-dir`` the run saves its state (format v2, asynchronously)
after every step ``t`` with ``(t + 1) % --ckpt-every == 0``, keeps the
newest ``--keep-last`` complete saves (and every ``--keep-every``-th step),
and a rerun resumes from the newest complete save: it restores into the
storage of a model and optimizer state allocated as a fresh run allocates
them (``abstract_train_state(..., device=)``), one leaf at a time and
straight into the model's own parameters, and continues bit for bit as the
uninterrupted run would. On a mesh every rank saves only its plan's part
(``train_state_shardings``) and the ranks commit one checkpoint together;
a rerun resumes from the newest complete step onto the current mesh,
whatever layout, process count or single process saved it, each rank
reading only its part into storage allocated as a fresh rank holds it
(``abstract_train_state(..., mesh=)``); the one-process run likewise
resumes a mesh's save. ``--digests`` adds each leaf's sha256 of the final
state (each rank's part on a mesh) to the summary, to compare two runs.
``--layers N`` keeps the arch's first N layers at full width (a depth cut
for a card the whole model does not fit, or a short run); on a mesh every
rank prints its state bytes and records the eigh work of each step
(Shampoo's recompute steps).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.comms import GRAD_COMM_MODES, CommsConfig, wire_report
from repro_torch.configs import ARCHS, cut_depth, get_config, reduced_config
from repro_torch.core.optimizers import (
    linear_warmup_linear_decay,
    make_optimizer,
    optimizer_names,
    state_nbytes,
)
from repro_torch.core.optimizers.base import _leaves
from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.io import CheckpointManager
from repro_torch.kernels import sr
from repro_torch.models import Transformer, init_model, named_params, param_axes
from repro_torch.train.train_loop import (
    TrainState,
    build_train_step,
    make_train_state,
    shard_train_state,
    train_state_shardings,
)

__all__ = ["main", "parse_args", "abstract_train_state"]


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
    ap.add_argument("--grad-comm", default="fp32", choices=list(GRAD_COMM_MODES),
                    help="gradient wire format; int8/int4 block-quantize the gradients")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="mesh of D*M local processes, e.g. 2x2 (data=2, model=2)")
    ap.add_argument("--run-dir", default=None,
                    help="--mesh: directory of the ranks' rendezvous "
                         "(default: a new temporary one)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--keep-last", type=int, default=3,
                    help="retention: keep the newest N complete checkpoints")
    ap.add_argument("--keep-every", type=int, default=None,
                    help="retention: also keep every K-th step")
    ap.add_argument("--digests", action="store_true",
                    help="add each leaf's sha256 of the final state to the summary")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the arch's first N layers (its width kept): a depth cut")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        d, x, m = args.mesh.partition("x")
        if not (x and d.isdigit() and m.isdigit() and int(d) >= 1 and int(m) >= 1):
            ap.error(f"--mesh {args.mesh!r}: expected DxM, e.g. 2x2")
    if args.ckpt_every < 1:
        ap.error("--ckpt-every: must be at least 1")
    for kv in args.opt_arg:
        if "=" not in kv:
            ap.error(f"--opt-arg {kv!r}: expected K=V (e.g. use_kernel=true)")
    return args


def _uses_stochastic_rounding(opt_state) -> bool:
    return any(isinstance(leaf, QuantizedTensor) and leaf.config.stochastic_rounding
               for leaf in _leaves(opt_state))


def abstract_train_state(cfg, optimizer, key=None, device=None, mesh=None, axes=None):
    """(model, TrainState) to restore into, counterpart of the reference's
    ``abstract_train_state``. By default on ``meta``: no parameter or moment
    has storage (the optimizer's step counts are 4-byte host tensors, as in
    every state of the port). With ``device``, the model and the optimizer
    state get uninitialised storage there, allocated as a fresh run
    allocates them (the model's parameters, then the optimizer's init), so
    a restore fills the model's own parameters in place and the resumed
    run's device memory peaks where a fresh run's does.

    With ``mesh`` (and ``axes``, ``models.param_axes(cfg)`` by default) the
    state is this rank's part under ``train_state_shardings``, as
    ``shard_train_state`` leaves a fresh rank holding it: its parameter
    tiles, then its part of the optimizer state, each allocated at its
    part's shape (on ``device``; on ``meta`` without it), and a ``meta``
    model. The whole model never has storage."""
    if mesh is not None:
        from repro_torch.sharding.context import rank_coord
        from repro_torch.sharding.specs import local_box, map_plan

        model = init_model(cfg, device="meta")
        whole = make_train_state(model, optimizer, key=key)
        plan = train_state_shardings(whole, axes if axes is not None else param_axes(cfg), mesh)
        coord = rank_coord(mesh)
        dev = resolve_device(device) if device is not None else torch.device("meta")

        def part(t, spec):
            shape = tuple(b - a for a, b in local_box(spec, tuple(t.shape), coord, mesh))
            return torch.empty(shape, dtype=t.dtype, device=dev if t.is_meta else t.device)

        params = {k: part(p, plan.params[k]) for k, p in whole.params.items()}
        return model, TrainState(params, map_plan(part, whole.opt_state, plan.opt_state), 0,
                                 key)
    if device is None:
        model = init_model(cfg, device="meta")
    else:
        model = Transformer(cfg, device=resolve_device(device))
    return model, make_train_state(model, optimizer, key=key)


def _digests(state) -> Dict[str, str]:
    """sha256 (16 hex digits) of each leaf of a state, one leaf at a time on
    the host."""
    from repro_torch.io.format import sha_bytes
    from repro_torch.io.tree import flatten_with_keys
    from repro_torch.io.writer import _device_to_host

    return {k: sha_bytes(_device_to_host(k, leaf).reshape(-1).view("uint8"))
            for k, leaf in flatten_with_keys(state)}


def _setup(args):
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    if cfg.input_mode == "embeds" or cfg.family == "encdec":
        raise SystemExit(f"{args.arch}: modality-stub arch — use examples/ or the dry-run")
    overrides = {k: _parse_value(v) for k, _, v in (kv.partition("=") for kv in args.opt_arg)}
    opt = make_optimizer(
        args.optimizer,
        linear_warmup_linear_decay(args.lr, max(1, args.steps // 10), args.steps),
        **overrides,
    )
    sr_key = sr.PRNGKey(args.sr_seed) if args.sr_seed is not None else None
    return cfg, opt, sr_key


def _split_counts(cfg, shape):
    """(leaves that compute tensor-parallel on the model axis, leaves
    gathered whole) of ``cfg`` on a (data, model) ``shape``
    (``sharding.tensor_parallel.placement``)."""
    from repro_torch.sharding.tensor_parallel import placement

    shapes = {k: tuple(p.shape) for k, p in named_params(init_model(cfg, device="meta")).items()}
    split = placement(shapes, param_axes(cfg), {"data": shape[0], "model": shape[1]})
    n = sum(d is not None for d in split.values())
    return n, len(split) - n


def _main_mesh(args, argv, device, cfg, opt) -> Dict:
    """``--mesh DxM``: D*M processes, rank 0's summary returned."""
    import torch.multiprocessing as mp

    d, _, m = args.mesh.partition("x")
    shape = (int(d), int(m))
    world = shape[0] * shape[1]
    own_card = device.type == "cuda" and torch.cuda.device_count() >= world
    backend = "nccl" if own_card else "gloo"
    where = ("one card per rank" if own_card else
             f"ranks share {device}; collectives copy through host memory"
             if device.type == "cuda" else "cpu")
    split = _split_counts(cfg, shape)
    print(f"mesh data={shape[0]} model={shape[1]}: {world} processes, backend={backend} ({where}); "
          f"tensor-parallel leaves {split[0]}, gathered whole {split[1]}", flush=True)
    # absolute: a relative path would read as the host of the file:// URL
    run_dir = os.path.abspath(args.run_dir or tempfile.mkdtemp(prefix="repro_mesh_"))
    os.makedirs(run_dir, exist_ok=True)
    store = os.path.join(run_dir, "rendezvous")
    if os.path.exists(store):
        os.remove(store)
    try:
        mp.spawn(_mesh_rank, args=(world, shape, argv, run_dir, backend), nprocs=world, join=True)
        with open(os.path.join(run_dir, "summary.json")) as f:
            return json.load(f)
    finally:
        if args.run_dir is None:
            shutil.rmtree(run_dir, ignore_errors=True)


def _mesh_rank(rank: int, world: int, shape, argv, run_dir: str, backend: str) -> None:
    import torch.distributed as dist

    from repro_torch.comms import collectives
    from repro_torch.core.optimizers.transform import EIGH
    from repro_torch.kernels import adamw4bit, quant4
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.fault_tolerance import plan_elastic

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    args = parse_args(argv)
    device = resolve_device(args.device)
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + os.path.join(run_dir, "rendezvous"),
                            rank=rank, world_size=world)
    try:
        collectives.open_host_slots()
        mesh = make_mesh(shape, ("data", "model"), "cuda" if backend == "nccl" else "cpu")
        cfg, opt, sr_key = _setup(args)
        axes = param_axes(cfg)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _, whole = abstract_train_state(cfg, opt, key=sr_key)  # shapes only
        n_params = sum(p.numel() for p in whole.params.values())
        whole_bytes = state_nbytes(whole.opt_state)
        plan = train_state_shardings(whole, axes, mesh)
        del whole
        mgr = (CheckpointManager(args.ckpt_dir, keep_last=args.keep_last,
                                 keep_every=args.keep_every) if args.ckpt_dir else None)
        # the newest complete step, whatever layout saved it; every rank must
        # resume from the same one
        start = plan_elastic(range(world), mgr.latest_step() if mgr else None).restore_step or 0
        starts = [None] * world
        dist.all_gather_object(starts, start)
        if len(set(starts)) != 1:
            raise RuntimeError(f"the ranks see different newest checkpoints: {starts}")
        ckpt = {"resumed_from": start, "restore_s": None, "saves": []}
        if start:
            model, state = abstract_train_state(cfg, opt, key=sr_key, device=device, mesh=mesh,
                                                axes=axes)
            t0 = time.perf_counter()
            state, _ = mgr.restore(state, device=device, shardings=plan, mesh=mesh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ckpt["restore_s"] = time.perf_counter() - t0
            if rank == 0:
                print(f"resumed from step {start} ({ckpt['restore_s']:.1f} s on rank 0)",
                      flush=True)
        else:
            model = init_model(cfg, seed=0, device=device)
            state = shard_train_state(make_train_state(model, opt, key=sr_key), mesh, axes)
        comms = CommsConfig.parse(args.grad_comm)
        if rank == 0:
            print(f"arch={cfg.name} params={n_params:,} optimizer={opt.name} "
                  f"state_bytes={whole_bytes:,} device={device}", flush=True)
        step_fn = build_train_step(model, opt, mesh, axes, comms=comms)
        data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
        records, eigh = [], []
        for t in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(t).items()}
            eigh0 = dict(EIGH)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            eigh.append({k: EIGH[k] - eigh0[k] for k in EIGH})
            records.append({"step": t, "loss": loss, "ms": ms,
                            "ce_loss": float(metrics["ce_loss"]),
                            "aux_loss": float(metrics["aux_loss"]),
                            "grad_norm": float(metrics["grad_norm"]), **step_fn.times})
            if mgr and (t + 1) % args.ckpt_every == 0:
                t0 = time.perf_counter()
                mgr.save(t + 1, state, shardings=plan, mesh=mesh)
                ckpt["saves"].append({"step": t + 1, "t0": t0,
                                      "stall_ms": (time.perf_counter() - t0) * 1e3})
            if rank == 0 and t % 5 == 0:
                print(f"step {t:4d} loss {loss:.4f} aux_loss {records[-1]['aux_loss']:.4f} "
                      f"({ms:.0f} ms)", flush=True)
        if mgr:
            mgr.wait()
            for rec in ckpt["saves"]:
                rec["commit_s"] = mgr.commit_times[rec["step"]] - rec.pop("t0")
        mine = {"state_bytes": state_nbytes(state.opt_state),
                "param_bytes": sum(p.numel() * p.element_size() for p in state.params.values()),
                "peak_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else 0),
                "checkpoint": ckpt if mgr else None,
                "launches": {**adamw4bit.LAUNCHES, **quant4.LAUNCHES},
                "eigh": eigh}  # Shampoo's eigh work a step on this rank
        if args.digests:
            mine["digests"] = _digests(state)
        every = [None] * world
        dist.all_gather_object(every, mine)
        ranks = []
        for r, row in enumerate(every):
            coord = step_fn.mesh_step.run.coords[r]
            ranks.append({"rank": r, **coord, **row})
            if rank == 0:
                print(f"rank {r} (data={coord['data']}, model={coord['model']}): "
                      f"state_bytes={row['state_bytes']:,} param_bytes={row['param_bytes']:,} "
                      f"peak_bytes={row['peak_bytes']:,}", flush=True)
                for rec in (row["checkpoint"] or {}).get("saves", []):
                    print(f"rank {r} checkpoint step {rec['step']}: save() stalled "
                          f"{rec['stall_ms']:.0f} ms, committed after {rec['commit_s']:.1f} s",
                          flush=True)
        if rank == 0:
            with open(os.path.join(run_dir, "summary.json"), "w") as f:
                json.dump({"arch": cfg.name, "optimizer": opt.name, "state_bytes": whole_bytes,
                           "n_params": n_params, "mesh": list(shape), "backend": backend,
                           "steps": records, "checkpoint": ckpt if mgr else None,
                           "ranks": ranks}, f)
        dist.barrier()  # no rank tears down while another still talks
    finally:
        collectives.close_host_slots()
        dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns a summary (per-step loss, its ce and MoE aux
    parts and ms, state bytes, the gradient wire report, peak device
    memory, checkpoint times) for callers such as ``chip_smoke.py``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, opt, sr_key = _setup(args)
    if args.mesh is not None:
        return _main_mesh(args, list(argv) if argv is not None else sys.argv[1:], device, cfg,
                          opt)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    mgr = (CheckpointManager(args.ckpt_dir, keep_last=args.keep_last,
                             keep_every=args.keep_every) if args.ckpt_dir else None)
    # the newest complete step: a save killed mid-write is skipped
    start = (mgr.latest_step() or 0) if mgr else 0
    ckpt = {"resumed_from": start, "restore_s": None, "saves": []}
    if start:
        # one name for the target and the restored state: a reference kept to
        # the target would keep its optimizer state alive after the first step
        model, state = abstract_train_state(cfg, opt, key=sr_key, device=device)
        t0 = time.perf_counter()
        state, _ = mgr.restore(state, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ckpt["restore_s"] = time.perf_counter() - t0
        print(f"resumed from step {start} ({ckpt['restore_s']:.1f} s)")
    else:
        model = init_model(cfg, seed=0, device=device)
        state = make_train_state(model, opt, key=sr_key)
    nbytes = state_nbytes(state.opt_state)
    n_params = sum(p.numel() for p in state.params.values())
    print(f"arch={cfg.name} params={n_params:,} optimizer={opt.name} "
          f"state_bytes={nbytes:,} device={device}")
    comms = CommsConfig.parse(args.grad_comm)
    wire = wire_report(state.params, comms)
    print(f"grad-comm={comms.name} collective_bytes/step={wire['total_wire_bytes']:,} "
          f"({wire['ratio_vs_fp32']:.2f}x fewer than fp32, "
          f"{wire['quantized_leaves']}/{wire['n_leaves']} leaves quantized)")
    if sr_key is None and _uses_stochastic_rounding(state.opt_state):
        print("warning: optimizer is configured for stochastic rounding but no --sr-seed was "
              "given — quantization falls back to biased round-to-nearest")
    if sr_key is None and comms.quantized and comms.stochastic_rounding:
        print(f"warning: --grad-comm {comms.mode} transports gradients with stochastic rounding "
              "but no --sr-seed was given — transport falls back to biased round-to-nearest")

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    step_fn = build_train_step(model, opt, comms=comms)
    records = []
    for t in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(t).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        records.append({"step": t, "loss": loss, "ms": ms,
                        "ce_loss": float(metrics["ce_loss"]),
                        "aux_loss": float(metrics["aux_loss"]),
                        "grad_norm": float(metrics["grad_norm"])})
        if mgr and (t + 1) % args.ckpt_every == 0:
            t0 = time.perf_counter()
            mgr.save(t + 1, state)
            ckpt["saves"].append({"step": t + 1, "t0": t0,
                                  "stall_ms": (time.perf_counter() - t0) * 1e3})
        if t % 5 == 0:
            print(f"step {t:4d} loss {loss:.4f} aux_loss {records[-1]['aux_loss']:.4f} "
                  f"({ms:.0f} ms)")
    if mgr:
        mgr.wait()
        for rec in ckpt["saves"]:
            rec["commit_s"] = mgr.commit_times[rec["step"]] - rec.pop("t0")
            print(f"checkpoint step {rec['step']}: save() stalled {rec['stall_ms']:.0f} ms, "
                  f"committed after {rec['commit_s']:.1f} s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    out = {"arch": cfg.name, "optimizer": opt.name, "state_bytes": nbytes,
           "n_params": n_params, "wire": wire, "steps": records, "peak_bytes": peak,
           "state": state, "checkpoint": ckpt if mgr else None}
    if args.digests:
        out["digests"] = _digests(state)
    return out


if __name__ == "__main__":
    main()
