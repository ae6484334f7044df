"""Dry run of every (arch × shape × mesh) cell on the ``meta`` device (port
of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 256 or 512 forced host
devices and records XLA's memory and cost analyses. The port needs no
process and no device: each cell builds the model, the optimizer state,
the inputs (``launch.specs``) and, for decode, the caches, all on
``meta``; lays them out with the plans of ``sharding.specs`` over the
production meshes ((data=16, model=16), or (pod=2, data=16, model=16)); and
records per rank:

* ``memory``: ``param_bytes`` (train: ``param_shardings(zero=True)``; serving:
  ``param_shardings``, bf16 weights), ``state_bytes``
  (``opt_state_shardings``), ``batch_bytes`` (``batch_shardings``),
  ``cache_bytes`` (``cache_shardings``) and their sum ``argument_bytes``,
  each the largest over the mesh's ranks (``plan_nbytes``); and, for train
  cells on the mesh path, ``gathered_layer_bytes``, the largest layer a
  rank gathers (one stack's layer: the model shard of a leaf that computes
  tensor-parallel, any other leaf whole), and ``gathered_top_bytes``, the
  top-level leaves it holds gathered through the step. XLA's temp and peak
  bytes have no counterpart and are not recorded;
* ``roofline``, ``cost`` and ``collectives`` from ``roofline.measured``
  at the rank's share, with the H100's constants.

``status`` is ``ok``, ``skipped`` (``cell_is_runnable``), ``refused`` (the
port's mesh step would refuse the cell before its first step: a
microbatch whose global tokens do not split into whole MoE groups,
``models.moe.moe_capacity``; the refusal's own message; a group that spans
data shards is no refusal, ``models.moe`` exchanges its routing counts over
the data group), or ``error`` with the traceback's tail. A fused
leaf whose tiles would cut B128 blocks, or a leaf whose tiles would cut a
packed byte of its 4-bit moments' codes, is no refusal (the mesh step
updates it on row tiles); such leaves are listed under
``row_tile_leaves``.

Usage:
    python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out results/dryrun.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, cell_is_runnable, get_config
from repro_torch.launch.specs import input_specs
from repro_torch.models import ModelConfig, init_model, named_params, param_axes
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.roofline.measured import _optimizer, measure, rank_batch
from repro_torch.sharding.rules import dp_size, mesh_axis_sizes
from repro_torch.sharding.specs import (
    batch_shardings,
    cache_shardings,
    mesh_coords,
    opt_state_shardings,
    param_shardings,
    plan_nbytes,
)

__all__ = ["MESHES", "dry_cell", "dry_run", "memory_record", "run_all", "main"]

# make_production_mesh's shapes
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def _rank_bytes(tree, plan, mesh) -> int:
    """The largest bytes any rank holds of ``tree`` under ``plan``:
    ``local_box`` cuts every dim into equal parts, so every rank holds the
    same, ``plan_nbytes`` at the first coordinate."""
    return plan_nbytes(tree, plan, mesh_coords(mesh)[0], mesh)


def _gathered_bytes(params: Mapping[str, torch.Tensor], axes, mesh) -> Dict[str, int]:
    """Bytes the mesh step holds gathered: the largest one layer of a stack
    (``train.mesh._Stack``), and the top-level leaves; a leaf that computes
    tensor-parallel (``sharding.tensor_parallel.placement``) as its model
    shard, any other whole."""
    from repro_torch.sharding.tensor_parallel import placement

    split = placement({k: tuple(p.shape) for k, p in params.items()}, axes, mesh)
    stacks: Dict[str, int] = {}
    top = 0
    for k, p in params.items():
        n = p.numel() * p.element_size() // (mesh["model"] if split[k] is not None else 1)
        if k.startswith(("decoder/", "encoder/")):
            stack = "/".join(k.split("/")[:3])
            stacks[stack] = stacks.get(stack, 0) + n // p.shape[0]
        else:
            top += n
    return {"gathered_layer_bytes": max(stacks.values(), default=0), "gathered_top_bytes": top}


def _refusal(cfg: ModelConfig, shape: ShapeSpec, mesh, accum_steps: int) -> Optional[str]:
    """Why the mesh step would refuse a train cell before its first step
    (None: it would not)."""
    from repro_torch.models.moe import moe_shard_groups

    try:
        if any(b.kind == "moe" for b in cfg.blocks):
            Bl, shards = rank_batch(shape.global_batch, dp_size(mesh))
            moe_shard_groups(Bl // accum_steps * shape.seq_len, shards, 0, cfg.top_k,
                             cfg.num_experts, group_size=cfg.moe_group_size)
    except ValueError as e:
        return str(e)
    return None


def memory_record(cfg: ModelConfig, shape: ShapeSpec, mesh: Mapping[str, int],
                  opt_name: str = "adamw4bit", accum_steps: int = 8) -> Dict[str, Any]:
    """A cell's per-rank bytes on ``mesh`` (``memory``) or its refusal
    (``status: refused``, ``reason``)."""
    mesh = mesh_axis_sizes(mesh)
    n_chips = 1
    for v in mesh.values():
        n_chips *= v
    params = {k: p.detach() for k, p in named_params(init_model(cfg, device="meta")).items()}
    axes = param_axes(cfg)
    train = shape.kind == "train"
    if not train:  # serving uses bf16 weights (no fp32 masters outside training)
        params = {k: torch.empty(p.shape, dtype=COMPUTE_DTYPE, device="meta")
                  for k, p in params.items()}
    specs = input_specs(cfg, shape)
    caches = specs.pop("caches", None)
    out: Dict[str, Any] = {"n_chips": n_chips, "accum_steps": accum_steps if train else None}
    memory = {"param_bytes": _rank_bytes(params, param_shardings(params, axes, mesh, zero=train),
                                         mesh)}
    if train:
        with torch.no_grad():
            meta_state = _optimizer(opt_name).init(params)
        why = _refusal(cfg, shape, mesh, accum_steps)
        if why is not None:
            return dict(out, status="refused", reason=why)
        memory["state_bytes"] = _rank_bytes(
            meta_state, opt_state_shardings(meta_state, params, axes, mesh, zero=True), mesh)
    else:
        memory["state_bytes"] = 0
    memory["batch_bytes"] = _rank_bytes(specs, batch_shardings(specs, mesh), mesh)
    memory["cache_bytes"] = (_rank_bytes(caches, cache_shardings(caches, mesh), mesh)
                             if caches is not None else 0)
    memory["argument_bytes"] = sum(memory[k] for k in ("param_bytes", "state_bytes",
                                                       "batch_bytes", "cache_bytes"))
    if train and n_chips > 1:
        memory.update(_gathered_bytes(params, axes, mesh))
    return dict(out, status="ok", memory=memory)


def dry_run(cfg: ModelConfig, shape: ShapeSpec, mesh: Mapping[str, int],
            opt_name: str = "adamw4bit", accum_steps: int = 8) -> Dict[str, Any]:
    """One cell's record (without ``arch``/``shape``/``mesh`` names): ``cfg``
    at ``shape`` on the ``{axis: size}`` mesh ``mesh``: ``memory_record``,
    then the roofline at the rank's share (``roofline.measured.measure``)."""
    record = memory_record(cfg, shape, mesh, opt_name, accum_steps)
    if record["status"] != "ok":
        return record
    rec = measure(cfg, shape, mesh, optimizer=opt_name, accum_steps=accum_steps)
    record.update(rank_batch=rec["rank_batch"], compute_split=rec["compute_split"],
                  flops_counted=rec["flops_counted"],
                  cost={"flops": rec["roofline"]["flops"],
                        "bytes accessed": rec["roofline"]["bytes_accessed"],
                        "flops by dtype": rec["flops_by_dtype"]},
                  collectives=rec["collectives"], roofline=rec["roofline"])
    if "row_tile_leaves" in rec:
        record["row_tile_leaves"] = rec["row_tile_leaves"]
    return record


def dry_cell(arch: str, shape_name: str, mesh_kind: str, opt_name: str = "adamw4bit",
             accum_steps: int = 8) -> Dict[str, Any]:
    """One cell's record. Train cells default to 8 microbatches, as the
    reference's ``lower_cell`` does."""
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    runnable, reason = cell_is_runnable(arch, shape_name)
    if not runnable:
        return dict(head, status="skipped", reason=reason)
    t0 = time.time()
    rec = dry_run(get_config(arch), SHAPES[shape_name], MESHES[mesh_kind], opt_name,
                  accum_steps)
    return dict(head, **rec, seconds=round(time.time() - t0, 2))


def run_all(out_path: str, meshes=("single", "multi"), archs=None, shapes=None,
            opt_name: str = "adamw4bit"):
    """Every cell not yet in ``out_path`` (resumable), written after each."""
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch in archs or ARCHS:
        for shape_name in shapes or SHAPES:
            for mesh_kind in meshes:
                if (arch, shape_name, mesh_kind) in done:
                    continue
                print(f"=== {arch} x {shape_name} x {mesh_kind} ===", flush=True)
                try:
                    rec = dry_cell(arch, shape_name, mesh_kind, opt_name)
                except Exception as e:  # record the failure, keep going
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(rec["error"], flush=True)
                results.append(rec)
                os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES), default="single")
    ap.add_argument("--opt", default="adamw4bit",
                    help="optimizer for train cells (e.g. production4bit)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    args = ap.parse_args(argv)

    if args.all:
        results = run_all(args.out, opt_name=args.opt)
        counts: Dict[str, int] = {}
        for r in results:
            counts[r["status"]] = counts.get(r["status"], 0) + 1
        print(f"dry run: {len(results)} records {counts} in {args.out}")
        return results
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    rec = dry_cell(args.arch, args.shape, args.mesh, opt_name=args.opt)
    print(json.dumps(rec, indent=1, default=str))
    return rec


if __name__ == "__main__":
    main()
