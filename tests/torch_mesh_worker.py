"""Ranks of the port's mesh tests (imported by spawned processes; torch only).

``spawn(world, tasks, tmp)`` starts ``world`` gloo processes that meet
through a ``FileStore`` in ``tmp`` (never a fixed port), runs every task
in every rank, and returns each rank's results (``start`` and ``collect``
split it, so the caller can work while the ranks run). A task is a dict with a
``kind`` (``allreduce``, ``reduce``, ``step``, ``optim``, ``optim_one``, ``losses``,
``tp_step``, ``tp_blocks``, ``moe_blocks``, ``recurrent_blocks``,
``fallback_blocks``, ``collectives``, and the checkpoint kinds ``save``,
``restore``, ``resume``, ``mesh_ckpt``, ``protocol``) and its inputs; a task
with ``after`` waits until that file exists (the caller writes its inputs
meanwhile). Each rank runs on one CPU thread (pytest runs several workers
at once).
"""

import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _allreduce(task, rank):
    from repro_torch.comms import quantized_all_reduce

    x = torch.from_numpy(task["x"][rank])
    qcfg = task["qcfg"]
    out = {"oracle_key": quantized_all_reduce(x, qcfg, None, key=task["key"])}
    acc = torch.zeros_like(x)
    for s in range(task["n_keys"]):
        r = quantized_all_reduce(x, qcfg, None, key=(0, 100 + s))
        acc += r
        if s == 0:
            out["single"] = r
    out["mean"] = acc / task["n_keys"]
    return out


def _wire_tiles(run, shapes, axes):
    from repro_torch.sharding.context import Tile
    from repro_torch.sharding.rules import wire_spec
    from repro_torch.sharding.specs import local_box

    boxes = {k: [local_box(wire_spec(s, axes[k], run.sizes), s, c, run.sizes) for c in run.coords]
             for k, s in shapes.items()}
    return boxes, {k: Tile(shapes[k], b[run.rank]) for k, b in boxes.items()}


def _reduce(task, rank):
    from repro_torch.comms import CommsConfig, reduce_grads
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import context
    from repro_torch.train.mesh import gather

    out = {}
    for shape in task["meshes"]:
        mesh = make_mesh(shape, ("data", "model"))
        run = context.MeshRun(mesh)
        grads = {k: torch.from_numpy(v) for k, v in task["grads"].items()}
        shapes = {k: tuple(v.shape) for k, v in grads.items()}
        boxes, tiles = _wire_tiles(run, shapes, task["axes"])
        mine = {k: g[tiles[k].index()].clone() for k, g in grads.items()}
        with context.use(run, tiles):
            red = reduce_grads(mine, task["axes"], mesh, CommsConfig(mode=task["mode"]),
                               key=task["key"])
        out[shape] = {k: gather(v, boxes[k], shapes[k]) for k, v in red.items()}
    return out


def _step(task, rank):
    from repro_torch.configs import reduced_config
    from repro_torch.convert import load_params
    from repro_torch.core.optimizers import make_optimizer, state_nbytes
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Transformer, init_model, named_params, param_axes
    from repro_torch.sharding.specs import plan_nbytes
    from repro_torch.train.train_loop import (
        build_train_step,
        make_train_state,
        shard_train_state,
    )

    cfg = reduced_config(task["arch"])
    mesh = make_mesh(task["mesh"], ("data", "model"))
    axes = param_axes(cfg)
    key = sr.PRNGKey(task["sr_seed"])
    params = {k: torch.from_numpy(v) for k, v in task["params"].items()}

    def fresh():
        model = Transformer(cfg, device="cpu")
        load_params(model, params)
        opt = make_optimizer(task["optimizer"], task["lr"])
        state = make_train_state(model, opt, key=key)
        return model, opt, shard_train_state(state, mesh, axes)

    out = {}
    # the update alone, fed the reference's gradients
    model, opt, state = fresh()
    fn = build_train_step(model, opt, mesh, axes)
    ms = fn.mesh_step
    out["tile_shapes"] = {k: tuple(p.shape) for k, p in state.params.items()}
    out["want_shapes"] = {k: ms.tiles[k].local_shape for k in state.params}
    out["state_bytes"] = state_nbytes(state.opt_state)
    meta = named_params(init_model(cfg, device="meta"))
    out["plan_bytes"] = plan_nbytes(opt.init(meta), ms.state_plan, ms.run.coord, ms.run.sizes)
    for t, g in enumerate(task["grads"]):
        tiles = {k: torch.from_numpy(v)[ms.tiles[k].index()].clone() for k, v in g.items()}
        with torch.no_grad():
            state.opt_state = ms.update(opt, tiles, state.opt_state, state.params,
                                        key=sr.fold_in(key, t))
    out["params"] = ms.whole_params(state.params)
    out["opt_state"] = ms.whole_state(state.opt_state)
    # end to end
    model, opt, state = fresh()
    fn = build_train_step(model, opt, mesh, axes)
    losses = []
    for batch in task["batches"]:
        state, metrics = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    out["losses"] = losses
    if task["mesh"][1] > 1:  # the compute split over model: also in fp32 compute
        with _compute_dtype(torch.float32):
            model, opt, state = fresh()
            out["losses_fp32"] = _run_losses(build_train_step(model, opt, mesh, axes), state,
                                             task["batches"])
    return out


@contextlib.contextmanager
def _compute_dtype(dtype):
    """The port's models compute in ``dtype`` within the block (every loaded
    ``repro_torch`` module's ``COMPUTE_DTYPE``, bound at import, set)."""
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch.") and hasattr(m, "COMPUTE_DTYPE")]
    old = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, old):
            m.COMPUTE_DTYPE = d


def _run_steps(fn, state, batches):
    """(loss, aux) of each step over ``batches``."""
    out = []
    for batch in batches:
        state, metrics = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        out.append((float(metrics["loss"]), float(metrics["aux_loss"])))
    return out


def _run_losses(fn, state, batches):
    losses = []
    for batch in batches:
        state, metrics = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses


def _optim(task, rank):
    """``_step`` on each of ``task["meshes"]`` for each of
    ``task["optimizers"]`` (``(name, overrides)``): the update fed the whole
    gradients for two steps (with the eigh blocks each step computed here,
    and the shapes this rank holds against its plan's), then the end-to-end
    losses; ``{mesh: {optimizer: result}}``."""
    from repro_torch.configs import reduced_config
    from repro_torch.convert import load_params
    from repro_torch.core.optimizers import make_optimizer, state_nbytes
    from repro_torch.core.optimizers.transform import EIGH
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Transformer, init_model, named_params, param_axes
    from repro_torch.sharding.specs import local_box, plan_leaves, plan_nbytes
    from repro_torch.train.mesh import _mirror_leaves
    from repro_torch.train.train_loop import (
        build_train_step,
        make_train_state,
        shard_train_state,
    )

    cfg = reduced_config(task["arch"])
    axes = param_axes(cfg)
    key = sr.PRNGKey(task["sr_seed"])
    params = {k: torch.from_numpy(v) for k, v in task["params"].items()}
    meta = named_params(init_model(cfg, device="meta"))
    out = {}
    for shape, (name, ov) in ((m, o) for m in task["meshes"] for o in task["optimizers"]):
        mesh = make_mesh(shape, ("data", "model"))
        def fresh():
            model = Transformer(cfg, device="cpu")
            load_params(model, params)
            opt = make_optimizer(name, task["lr"], **ov)
            state = make_train_state(model, opt, key=key)
            return model, opt, shard_train_state(state, mesh, axes)

        res = {}
        model, opt, state = fresh()
        ms = build_train_step(model, opt, mesh, axes).mesh_step
        meta_state = opt.init(meta)
        res["state_bytes"] = state_nbytes(state.opt_state)
        res["plan_bytes"] = plan_nbytes(meta_state, ms.state_plan, ms.run.coord, ms.run.sizes)
        res["held"] = [(tuple(t.shape), local_box(p, tuple(w.shape), ms.run.coord, ms.run.sizes),
                        tuple(w.shape))
                       for (t, _), (w, p) in zip(plan_leaves(state.opt_state, ms.state_plan),
                                                 plan_leaves(meta_state, ms.state_plan))]
        # the parameters several ranks hold a box of, the ranges of whole
        # blocks of each Shampoo leaf, and each factor stack held (local
        # and whole shape of its tensor, or of its codes)
        res["shared_boxes"] = [k for k, t in ms.work_tiles.items()
                               if isinstance(k, str) and len(t.firsts()) < ms.run.world]
        res["block_ranges"] = {k: sorted({b[0] for b in t.boxes})
                               for (k, f), t in ((k, t) for k, t in ms.work_tiles.items()
                                                 if isinstance(k, tuple)) if f == "stats_l"}
        held = lambda v: tuple((v.codes if hasattr(v, "codes") else v).shape)
        whole = {(k, f): held(v) for k, f, v in _mirror_leaves(meta_state, ms.shapes)
                 if (k, f) in ms.stack_work}
        res["stacks"] = [(k, f, held(v), whole[(k, f)])
                         for k, f, v in _mirror_leaves(state.opt_state, ms.shapes)
                         if (k, f) in ms.stack_work]
        res["eigh_blocks"] = []
        for t, g in enumerate(task["grads"]):
            tiles = {k: torch.from_numpy(v)[ms.tiles[k].index()].clone() for k, v in g.items()}
            EIGH["blocks"] = 0
            with torch.no_grad():
                state.opt_state = ms.update(opt, tiles, state.opt_state, state.params,
                                            key=sr.fold_in(key, t))
            res["eigh_blocks"].append(EIGH["blocks"])
        res["params"] = ms.whole_params(state.params)
        res["opt_state"] = ms.whole_state(state.opt_state)
        model, opt, state = fresh()
        res["losses"] = _run_losses(build_train_step(model, opt, mesh, axes), state,
                                    task["batches"])
        if shape != (1, 1):  # the batch or the compute split: also in fp32 compute
            with _compute_dtype(torch.float32):
                model, opt, state = fresh()
                res["losses_fp32"] = _run_losses(build_train_step(model, opt, mesh, axes),
                                                 state, task["batches"])
        out.setdefault(shape, {})[name] = res
    return out


def _optim_one(task, rank):
    """``_optim``'s runs in one process, off the mesh (a world of one): the
    update fed the whole gradients (with the eigh blocks of each step) and
    the end-to-end losses."""
    from repro_torch.configs import reduced_config
    from repro_torch.convert import load_params
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.core.optimizers.transform import EIGH
    from repro_torch.kernels import sr
    from repro_torch.models import Transformer
    from repro_torch.train.train_loop import build_train_step, make_train_state

    cfg = reduced_config(task["arch"])
    key = sr.PRNGKey(task["sr_seed"])
    params = {k: torch.from_numpy(v) for k, v in task["params"].items()}
    out = {}
    for name, ov in task["optimizers"]:
        def fresh():
            model = Transformer(cfg, device="cpu")
            load_params(model, params)
            opt = make_optimizer(name, task["lr"], **ov)
            return model, opt, make_train_state(model, opt, key=key)

        model, opt, state = fresh()
        eigh = []
        for t, g in enumerate(task["grads"]):
            EIGH["blocks"] = 0
            with torch.no_grad():
                _, state.opt_state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                                state.opt_state, state.params,
                                                key=sr.fold_in(key, t))
            eigh.append(EIGH["blocks"])
        res = {"params": {k: p.detach().clone() for k, p in state.params.items()},
               "state": state.opt_state, "eigh_blocks": eigh}
        model, opt, state = fresh()
        res["losses"] = _run_losses(build_train_step(model, opt), state, task["batches"])
        with _compute_dtype(torch.float32):
            model, opt, state = fresh()
            res["losses_fp32"] = _run_losses(build_train_step(model, opt), state,
                                             task["batches"])
        out[name] = res
    return out


def _losses(task, rank):
    """End-to-end (loss, aux) of the mesh step from ``init_model(seed=0)``
    (the reduced config with the task's ``overrides``, if any); with
    ``fp32``, ``{"bf16": ..., "fp32": ...}``, the same steps in fp32 compute
    beside."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_model, param_axes
    from repro_torch.train.train_loop import (
        build_train_step,
        make_train_state,
        shard_train_state,
    )

    if task.get("compute") == "fp32":
        with _compute_dtype(torch.float32):
            return _losses(dict(task, compute=None), rank)
    cfg = dataclasses.replace(reduced_config(task["arch"]), **task.get("overrides", {}))
    mesh = make_mesh(task["mesh"], ("data", "model"))
    axes = param_axes(cfg)
    model = init_model(cfg, seed=0, device="cpu")
    opt = make_optimizer(task["optimizer"], task["lr"])
    state = shard_train_state(make_train_state(model, opt, key=sr.PRNGKey(task["sr_seed"])),
                              mesh, axes)
    out = _run_steps(build_train_step(model, opt, mesh, axes), state, task["batches"])
    if task.get("fp32"):  # and the same steps in fp32 compute
        return {"bf16": out, "fp32": _losses(dict(task, fp32=False, compute="fp32"), rank)}
    return out


def _tp_step(task, rank):
    """The mesh step from the task's whole ``params`` (the reference's) on
    each of ``task["meshes"]``: the gradient of the first batch, gathered
    whole (``forward_backward``); 2 steps end to end with each step's
    ``STATS`` bytes and recorded calls, and ``MeshStep.reckon`` of the same
    step on this rank's ``meta`` parts; the leaves the step splits; the
    calls of the ``embed``-cut modes in the steps (``CALLS``); with
    ``fp32``, the steps' (loss, aux) in fp32 compute; ``partial: "bf16"``
    keeps the row-parallel partials in bf16; ``overrides`` replaces fields
    of the reduced config (``remat``); ``whole_params`` returns the
    parameters after the steps, whole. ``{mesh: result}``."""
    import dataclasses

    from repro_torch.comms import CommsConfig
    from repro_torch.comms.collectives import recording
    from repro_torch.configs import reduced_config
    from repro_torch.convert import load_params
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Transformer, init_model, named_params, param_axes
    from repro_torch.roofline.measured import Counter
    from repro_torch.sharding.context import MeshRun
    from repro_torch.sharding.specs import local_slice, map_plan
    from repro_torch.train.mesh import MeshStep, gather
    from repro_torch.train.train_loop import (
        build_train_step,
        make_train_state,
        shard_train_state,
    )

    from repro_torch.sharding import tensor_parallel as T

    cfg = dataclasses.replace(reduced_config(task["arch"]), **task.get("overrides", {}))
    axes = param_axes(cfg)
    key = sr.PRNGKey(task["sr_seed"])
    params = {k: torch.from_numpy(v) for k, v in task["params"].items()}
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in task["batches"]]
    # the row-parallel partials' type (bf16: the other choice, measured)
    T.PARTIAL_DTYPE = torch.bfloat16 if task.get("partial") == "bf16" else torch.float32
    out = {}
    for shape in task["meshes"]:
        mesh = make_mesh(shape, ("data", "model"))

        def fresh():
            model = Transformer(cfg, device="cpu")
            load_params(model, params)
            opt = make_optimizer("production4bit", task["lr"])
            state = shard_train_state(make_train_state(model, opt, key=key), mesh, axes)
            return opt, state, build_train_step(model, opt, mesh, axes)

        opt, state, fn = fresh()
        ms = fn.mesh_step
        res = {"split": {k: d for k, d in ms.split.items() if d is not None},
               "model_ranks": ms.run.model_ranks}
        g, _ = ms.forward_backward(state.params, batches[0], 1)
        res["grads"] = {k: gather(v, ms.boxes[k], ms.shapes[k]) for k, v in g.items()}
        del g
        opt, state, fn = fresh()
        losses, aux, stats, recorded = [], [], [], []
        T.CALLS.update(dict.fromkeys(T.CALLS, 0))
        for b in batches:
            with recording() as rec:
                state, metrics = fn(state, b)
            losses.append(float(metrics["loss"]))
            aux.append(float(metrics["aux_loss"]))
            stats.append(fn.times["collective_bytes"])
            recorded.append(list(rec))
        res.update(losses=losses, aux=aux, stats_bytes=stats, recorded=recorded,
                   calls=dict(T.CALLS))
        if task.get("whole_params"):  # the parameters after the steps, whole
            res["params"] = ms.whole_params(state.params)
        if task.get("fp32"):  # the same steps in fp32 compute
            with _compute_dtype(torch.float32):
                opt, state, fn = fresh()
                res["fp32"] = []
                for b in batches:
                    state, metrics = fn(state, b)
                    res["fp32"].append((float(metrics["loss"]), float(metrics["aux_loss"])))
        # the same step reckoned with no world on this rank's meta parts
        meta = {k: p.detach() for k, p in named_params(init_model(cfg, device="meta")).items()}
        with torch.no_grad():
            meta_state = opt.init(meta)
        run = MeshRun(dict(zip(("data", "model"), shape)), rank=rank)
        dry = MeshStep(run, cfg, {k: tuple(p.shape) for k, p in meta.items()}, axes, meta,
                       meta_state)
        cut = lambda t, spec: local_slice(t, spec, run.coord, run.sizes).clone()
        local = {k: cut(p, dry.param_plan[k]) for k, p in meta.items()}
        parts = map_plan(cut, meta_state, dry.state_plan)
        shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batches[0].items()}
        with Counter():
            res["reckoned"] = dry.reckon(local, parts, opt, key, 1, CommsConfig(),
                                         batch=shapes)
        out[tuple(shape)] = res
    return out


def _block_shards(block, p, rank, world, cfg):
    """A rank's model shard of a block's whole leaves (the placement rule:
    attention heads, kv heads where the world divides them, mlp columns,
    vocab rows), as new leaves."""
    cut = {"attention": {"wq": 1, "wo": 0, "wk": 1, "wv": 1},
           "mlp": {"w1": 1, "w3": 1, "w2": 0}, "vocab": {"embed": 0}}[block]
    if block == "attention" and cfg.num_kv_heads % world:
        cut = {k: d for k, d in cut.items() if k not in ("wk", "wv")}
    out = {}
    for k, v in p.items():
        if k in cut:
            n = v.shape[cut[k]] // world
            v = v.narrow(cut[k], rank * n, n)
        out[k] = v.clone().requires_grad_()
    return out


def _tp_blocks(task, rank):
    """Each case's block on this rank's model shard (a world of ``M`` ranks,
    one model group), forward and backward against the case's cotangent:
    head-parallel attention, mlp-parallel MLP, the vocab-parallel lookup
    and cross entropy; in the case's compute type and partial type. Returns
    per case the output, the input's gradient and each leaf's gradient (of
    the rank's shard). With ``unrecomputed``, the cross entropy's chunks
    run once and are saved, not recomputed in the backward (the
    recompute's oracle)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import layers as L
    from repro_torch.models.blocks import apply_attention, apply_mlp
    from repro_torch.models.layers import vocab_parallel_cross_entropy, vocab_parallel_lookup
    from repro_torch.sharding import tensor_parallel as T

    world = dist.get_world_size()
    tp = T.TPRun(None, rank, world)
    out = []
    recomputed = L.recomputed
    if task.get("unrecomputed"):
        L.recomputed = lambda fn, *args: fn(*args)
    try:
        for case in task["cases"]:
            dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
            T.PARTIAL_DTYPE = (torch.float32 if case.get("partial", "fp32") == "fp32"
                               else torch.bfloat16)
            try:
                with _compute_dtype(dtype), T.use(tp):
                    cfg = dataclasses.replace(reduced_config(case["arch"]),
                                              **case.get("cfg", {}))
                    p = _block_shards(case["block"], {k: torch.from_numpy(v)
                                                      for k, v in case["params"].items()},
                                      rank, world, cfg)
                    x = torch.from_numpy(case["x"]).to(dtype).requires_grad_()
                    cot = torch.from_numpy(case["cot"])
                    if case["block"] == "attention":
                        pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
                        y = apply_attention(p, x, cfg, window=case["window"], positions=pos)
                        total = (y.float() * cot).sum()
                    elif case["block"] == "mlp":
                        y = apply_mlp(p, x, case["act"], case["width"])
                        total = (y.float() * cot).sum()
                    else:
                        ids = torch.from_numpy(case["ids"])
                        rows = vocab_parallel_lookup(p["embed"], ids, tp)
                        labels = torch.from_numpy(case["labels"])
                        loss = vocab_parallel_cross_entropy(x, p["embed"].t(), labels, tp,
                                                            logit_cap=cfg.final_softcap, chunk=8)
                        y = {"rows": rows.detach(), "loss": loss.detach()}
                        total = loss + (rows.float() * cot).sum()
                    total.backward()
            finally:
                T.PARTIAL_DTYPE = torch.float32
            out.append({"y": y.detach() if torch.is_tensor(y) else y, "x_grad": x.grad,
                        "grads": {k: v.grad for k, v in p.items()}})
    finally:
        L.recomputed = recomputed
    return out


def recurrent_cuts(kind, shapes, world):
    """``{leaf: the dim a model axis of ``world`` cuts, or None}`` of one
    block's leaves (``shapes``: ``{path in the block: shape}``),
    by the placement rule (``tensor_parallel.placement`` on the leaves
    stacked as one layer)."""
    from repro_torch.models.axes import leaf_axes
    from repro_torch.sharding import tensor_parallel as T

    paths = {f"decoder/0/sub0/{k}": k for k in shapes}
    split = T.placement({p: (1,) + tuple(shapes[k]) for p, k in paths.items()},
                        {p: ("layers",) + leaf_axes(kind, k) for p, k in paths.items()},
                        {"data": 1, "model": world})
    return {k: None if split[p] is None else split[p] - 1 for p, k in paths.items()}


def _recurrent_blocks(task, rank):
    """Each case's recurrent block (``models.blocks.RECURRENT``: mLSTM,
    sLSTM, hymba) on this rank's model shard of its leaves
    (``recurrent_cuts``; a world of ``M`` ranks, one model group), forward
    and backward against the case's cotangent, in the case's compute type.
    Returns per case the output, the input's gradient and each leaf's
    gradient (of the rank's shard)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.sharding import tensor_parallel as T

    world = dist.get_world_size()
    tp = T.TPRun(None, rank, world)
    out = []
    for case in task["cases"]:
        dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
        cuts = recurrent_cuts(case["kind"], {k: v.shape for k, v in case["params"].items()},
                              world)
        flat = {}
        for k, v in case["params"].items():
            v = torch.from_numpy(v)
            if cuts[k] is not None:
                n = v.shape[cuts[k]] // world
                v = v.narrow(cuts[k], rank * n, n)
            flat[k] = v.clone().requires_grad_()
        with _compute_dtype(dtype), T.use(tp):
            cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfg"])
            x = torch.from_numpy(case["x"]).to(dtype).requires_grad_()
            y = recurrent_apply(case["kind"], flat, x, cfg)
            (y.float() * torch.from_numpy(case["cot"])).sum().backward()
        out.append({"y": y.detach(), "x_grad": x.grad,
                    "grads": {k: v.grad for k, v in flat.items()}})
    return out


def recurrent_apply(kind, flat, x, cfg):
    """A recurrent block of ``kind`` on ``{path in the block: leaf}`` (the
    leaves under ``attn/`` and ``mlp/`` nested): its output."""
    from repro_torch.models.blocks import RECURRENT, LayerSpec

    p = {}
    for k, v in flat.items():
        *dirs, name = k.split("/")
        node = p
        for d in dirs:
            node = node.setdefault(d, {})
        node[name] = v
    B, S = x.shape[:2]
    pos = torch.arange(S)[None].expand(B, -1)
    return RECURRENT[kind](p, x, LayerSpec(kind), cfg, positions=pos)[0]


def fallback_cuts(block, shapes, world):
    """``{leaf: the dim a model axis of ``world`` cuts, or None}`` of one
    ``embed``-cut case's leaves (``shapes``: ``{leaf: shape}``; an
    attention's per-layer leaves, or the top-level ``embed`` / ``head``), by
    the placement rule (``tensor_parallel.placement``)."""
    from repro_torch.models.axes import _TOP
    from repro_torch.sharding import tensor_parallel as T

    if block == "attention":  # one layer of a dense block's attention
        cuts = recurrent_cuts("dense", {f"attn/{k}": s for k, s in shapes.items()}, world)
        return {k.split("/", 1)[1]: d for k, d in cuts.items()}
    return T.placement({k: tuple(s) for k, s in shapes.items()}, {k: _TOP[k] for k in shapes},
                       {"data": 1, "model": world})


def fallback_apply(case, p, x, cfg, tp=None):
    """An ``embed``-cut case's block on leaves ``p`` and input ``x``: with
    ``tp``, the model-shard functions of ``sharding.tensor_parallel``
    (row-parallel attention, the column-parallel lookup, the row-parallel
    cross entropy), else the one-process ones. Returns (its output, the
    scalar its backward starts from, the cross-attention's source or
    None)."""
    from repro_torch.models import layers as L
    from repro_torch.models.blocks import apply_attention

    cot = torch.from_numpy(case["cot"])
    if case["block"] == "attention":
        src = None
        if "source" in case:
            src = torch.from_numpy(case["source"]).to(x.dtype).requires_grad_()
            y = apply_attention(p, x, cfg, causal=False, kv_source=src)
        else:
            pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
            y = apply_attention(p, x, cfg, window=case.get("window", 0), positions=pos)
        return y, (y.float() * cot).sum(), src
    if case["block"] == "lookup":
        ids = torch.from_numpy(case["ids"])
        y = (L.embed_lookup(p["embed"], ids) if tp is None
             else L.column_parallel_lookup(p["embed"], ids, tp))
        return y, (y.float() * cot).sum(), None
    head = p["embed"].t() if "embed" in p else p["head"]
    labels = torch.from_numpy(case["labels"])
    kw = dict(logit_cap=cfg.final_softcap, chunk=8)
    loss = (L.chunked_cross_entropy(x, head, labels, **kw) if tp is None
            else L.row_parallel_cross_entropy(x, head, labels, tp, **kw))
    return loss, loss, None


def _fallback_blocks(task, rank):
    """Each case whose ``worlds`` hold this world's size (a world of ``M``
    ranks, one model group) on this rank's model shard of its leaves
    (``fallback_cuts``), forward and backward (``fallback_apply``), in the
    case's compute type. Returns per case (None where it does not run here)
    the output, the gradients of the input and the source, each leaf's
    gradient (of the rank's shard) and the modes' ``CALLS``."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.sharding import tensor_parallel as T

    world = dist.get_world_size()
    tp = T.TPRun(None, rank, world)
    out = []
    for case in task["cases"]:
        if world not in case["worlds"]:
            out.append(None)
            continue
        dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
        cuts = fallback_cuts(case["block"], {k: v.shape for k, v in case["params"].items()},
                             world)
        p = {}
        for k, v in case["params"].items():
            v = torch.from_numpy(v)
            if cuts[k] is not None:
                n = v.shape[cuts[k]] // world
                v = v.narrow(cuts[k], rank * n, n)
            p[k] = v.clone().requires_grad_()
        T.CALLS.update(dict.fromkeys(T.CALLS, 0))
        with _compute_dtype(dtype), T.use(tp):
            cfg = dataclasses.replace(reduced_config(case["arch"]), **case["cfg"])
            x = torch.from_numpy(case["x"]).to(dtype).requires_grad_()
            y, total, src = fallback_apply(case, p, x, cfg, tp)
            total.backward()
        out.append({"y": y.detach(), "x_grad": x.grad,
                    "src_grad": None if src is None else src.grad,
                    "grads": {k: v.grad for k, v in p.items()}, "calls": dict(T.CALLS)})
    return out


def _moe_blocks(task, rank):
    """Each case's MoE layer (``models.moe.moe_apply``) on this rank's part,
    a world of ``N`` ranks: ``shards`` (the batch's rows cut into ``N``
    data shards in rank order, the routing's counts exchanged over the
    world), or one model group whose ranks hold their experts (``cut:
    "experts"``) or each expert's columns (``"mlp"``); in the case's compute
    type. The rank's loss is ``N`` times its output against its rows of the
    cotangent, plus its aux (so the ranks' mean is the one-process loss
    where the batch is cut, as the mesh step averages the data shards).
    Returns per case the output, the aux, the input's gradient and each
    leaf's gradient (of the rank's part)."""
    from repro_torch.models.moe import moe_apply
    from repro_torch.sharding import tensor_parallel as T
    from repro_torch.sharding.context import batch_shards

    world = dist.get_world_size()
    out = []
    for case in task["cases"]:
        dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
        cut = {"experts": {"w1": 0, "w3": 0, "w2": 0},
               "mlp": {"w1": 2, "w3": 2, "w2": 1}}.get(case.get("cut"), {})
        p = {}
        for k, v in case["params"].items():
            v = torch.from_numpy(v)
            if k in cut:
                n = v.shape[cut[k]] // world
                v = v.narrow(cut[k], rank * n, n)
            p[k] = v.clone().requires_grad_()
        x, cot = torch.from_numpy(case["x"]), torch.from_numpy(case["cot"])
        if case.get("shards"):
            rows = x.shape[0] // world
            x, cot = x[rank * rows:(rank + 1) * rows], cot[rank * rows:(rank + 1) * rows]
        with _compute_dtype(dtype):
            x = x.to(dtype).requires_grad_()
            split = (batch_shards(world, rank, None) if case.get("shards")
                     else T.use(T.TPRun(None, rank, world) if cut else None))
            with split:
                y, aux = moe_apply(p, x, top_k=case["top_k"], group_size=case["group_size"],
                                   width=case["params"]["w1"].shape[-1])
                scale = world if case.get("shards") else 1
                (scale * (y.float() * cot).sum() + aux).backward()
        out.append({"y": y.detach(), "aux": aux.detach(), "x_grad": x.grad,
                    "grads": {k: v.grad for k, v in p.items()}})
    return out


def _collectives(task, rank):
    """Per run (grad-comm mode, accumulation steps): the collective bytes
    ``STATS`` counts in one mesh train step, and the calls that
    ``collectives.recording`` records around it."""
    from repro_torch.comms import CommsConfig
    from repro_torch.comms.collectives import recording
    from repro_torch.configs import reduced_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_model, param_axes
    from repro_torch.train.train_loop import (
        build_train_step,
        make_train_state,
        shard_train_state,
    )

    cfg = reduced_config(task["arch"])
    mesh = make_mesh(task["mesh"], ("data", "model"))
    axes = param_axes(cfg)
    batch = {k: torch.from_numpy(v) for k, v in task["batch"].items()}
    out = []
    for mode, accum in task["runs"]:
        model = init_model(cfg, seed=0, device="cpu")
        opt = make_optimizer(task["optimizer"], task["lr"])
        state = shard_train_state(make_train_state(model, opt, key=sr.PRNGKey(task["sr_seed"])),
                                  mesh, axes)
        fn = build_train_step(model, opt, mesh, axes, accum_steps=accum,
                              comms=CommsConfig(mode=mode))
        with recording() as rec:
            state, _ = fn(state, batch)
        out.append({"stats_bytes": fn.times["collective_bytes"], "recorded": list(rec)})
    return out


def _slots(task, rank):
    """The shared-memory transport's chunked rounds against gloo's own
    transport: slots opened at ``HOST_MIN_BYTES`` (the least that takes
    them), payloads of several slots, over the world and over a group of
    ranks 0 and 2; the slots then opened again at their default size."""
    from repro_torch.comms import collectives as C

    world = dist.get_world_size()
    g = torch.Generator().manual_seed(rank)
    # fp32 elements: the gather's payload 3 slots and a bit, the exchange's
    # pieces a slot and a bit each (a round carries a slot / world of each)
    x = torch.randn(3 * C.HOST_MIN_BYTES // 4 + 5, generator=g)
    pieces = torch.randn(world, C.HOST_MIN_BYTES // 4 + 7, generator=g)
    pair = dist.new_group([0, 2])

    def run():
        out = {"gather": C.all_gather(x), "exchange": C.all_to_all(pieces)}
        if rank in (0, 2):
            out["pair_gather"] = C.all_gather(x, pair)
            out["pair_exchange"] = C.all_to_all(pieces[:2], pair)
        return out

    assert C.open_host_slots(C.HOST_MIN_BYTES)
    chunk = C._SLOTS.plan(None)[0]
    shm = run()
    C.close_host_slots()
    assert C._SLOTS.plan(None) is None
    gloo = run()
    C.open_host_slots()
    return {"chunk": chunk, "x_bytes": x.numel() * 4, "piece_bytes": pieces[0].numel() * 4,
            "equal": {k: torch.equal(shm[k], gloo[k]) for k in gloo},
            "shm": shm, "gloo": gloo,
            "left": [f for f in os.listdir("/dev/shm") if f.startswith(f"repro_{os.getpid()}_")]}


def _ckpt_setup(task):
    """(cfg, optimizer, SR key, axes) of a checkpoint task."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.kernels import sr
    from repro_torch.models import param_axes

    cfg = reduced_config(task["arch"])
    return (cfg, make_optimizer(task["optimizer"], task["lr"], **task.get("overrides", {})),
            sr.PRNGKey(task["sr_seed"]), param_axes(cfg))


def _plan(cfg, opt, key, axes, mesh):
    from repro_torch.launch.train import abstract_train_state
    from repro_torch.train.train_loop import train_state_shardings

    return train_state_shardings(abstract_train_state(cfg, opt, key=key)[1], axes, mesh)


def _host_leaves(state):
    from repro_torch.io.tree import flatten_with_keys

    return [(k, v.detach().clone() if isinstance(v, torch.Tensor) else torch.from_numpy(v.copy()))
            for k, v in flatten_with_keys(state)]


def _save(task, rank):
    """A whole state restored from a one-process save (``src``), cut to this
    rank's part and saved on ``mesh`` into ``dst``; every device-to-host copy
    recorded."""
    from repro_torch.io import restore_checkpoint, save_checkpoint, writer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import abstract_train_state
    from repro_torch.train.train_loop import shard_train_state

    cfg, opt, key, axes = _ckpt_setup(task)
    mesh = make_mesh(task["mesh"], ("data", "model"))
    _, target = abstract_train_state(cfg, opt, key=key, device="cpu")
    whole, _ = restore_checkpoint(task["src"], target, device="cpu")
    state = shard_train_state(whole, mesh, axes)
    copies = []
    real = writer._device_to_host
    writer._device_to_host = lambda k, leaf: copies.append((k, leaf.nbytes)) or real(k, leaf)
    try:
        save_checkpoint(task["dst"], int(state.step), state,
                        shardings=_plan(cfg, opt, key, axes, mesh), mesh=mesh)
    finally:
        writer._device_to_host = real
    return {"copies": copies}


def _restore(task, rank):
    """``src`` restored onto each of ``meshes``: this rank's leaves, and the
    size of every region the reader allocated."""
    from repro_torch.io import reader, restore_checkpoint
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import abstract_train_state

    cfg, opt, key, axes = _ckpt_setup(task)
    out = {}
    for shape in task["meshes"]:
        mesh = make_mesh(shape, ("data", "model"))
        _, target = abstract_train_state(cfg, opt, key=key, device="cpu", mesh=mesh, axes=axes)
        regions = []
        real = reader._alloc_region
        reader._alloc_region = lambda k, s, dt: regions.append(
            (k, int(np.prod(s, dtype=np.int64)) * np.dtype(dt).itemsize)) or real(k, s, dt)
        try:
            state, _ = restore_checkpoint(task["src"], target, device="cpu",
                                          shardings=_plan(cfg, opt, key, axes, mesh), mesh=mesh)
        finally:
            reader._alloc_region = real
        out[shape] = {"leaves": _host_leaves(state), "regions": regions}
    return out


def _resume(task, rank):
    """The newest step of ``src`` restored onto ``mesh`` by
    ``checkpoint_hooks``' ``restore_latest`` (elastic when it was saved on
    another layout), then one mesh update fed the whole ``grads``; the whole
    params and state gathered after."""
    from repro_torch.io import CheckpointManager
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import abstract_train_state
    from repro_torch.train.fault_tolerance import checkpoint_hooks
    from repro_torch.train.train_loop import build_train_step

    cfg, opt, key, axes = _ckpt_setup(task)
    mesh = make_mesh(task["mesh"], ("data", "model"))
    model, _ = abstract_train_state(cfg, opt, key=key, mesh=mesh, axes=axes)
    held = {}
    _, restore_latest = checkpoint_hooks(
        CheckpointManager(task["src"]), get_state=lambda: held["state"],
        set_state=lambda st: held.__setitem__("state", st),
        make_target=lambda: abstract_train_state(cfg, opt, key=key, device="cpu", mesh=mesh,
                                                 axes=axes)[1],
        device="cpu", make_shardings=lambda: (_plan(cfg, opt, key, axes, mesh), mesh))
    resumed = restore_latest()
    state = held["state"]
    ms = build_train_step(model, opt, mesh, axes).mesh_step
    tiles = {k: torch.from_numpy(v)[ms.tiles[k].index()].clone()
             for k, v in task["grads"].items()}
    with torch.no_grad():
        new = ms.update(opt, tiles, state.opt_state, state.params,
                        key=sr.fold_in(key, int(state.step)))
    return {"resumed": resumed, "step": int(state.step), "params": ms.whole_params(state.params),
            "opt_state": ms.whole_state(new)}


def _mesh_ckpt(task, rank):
    """A nonzero state on (2, 1) (two mesh updates fed the whole ``grads``)
    saved into ``dst`` with its plan, then restored on (1, 2) in the same
    processes: both whole states, gathered on every rank."""
    from repro_torch.io import restore_checkpoint, save_checkpoint
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import abstract_train_state
    from repro_torch.models import init_model
    from repro_torch.train.train_loop import build_train_step, make_train_state, shard_train_state

    cfg, opt, key, axes = _ckpt_setup(task)
    mesh = make_mesh((2, 1), ("data", "model"))
    model = init_model(cfg, seed=0, device="cpu")
    state = shard_train_state(make_train_state(model, opt, key=key), mesh, axes)
    ms = build_train_step(model, opt, mesh, axes).mesh_step
    for t, g in enumerate(task["grads"]):
        tiles = {k: torch.from_numpy(v)[ms.tiles[k].index()].clone() for k, v in g.items()}
        with torch.no_grad():
            state.opt_state = ms.update(opt, tiles, state.opt_state, state.params,
                                        key=sr.fold_in(key, t))
    state.step = len(task["grads"])
    save_checkpoint(task["dst"], state.step, state, shardings=_plan(cfg, opt, key, axes, mesh),
                    mesh=mesh)
    out = {"saved": {"params": ms.whole_params(state.params),
                     "opt_state": ms.whole_state(state.opt_state)}}
    mesh2 = make_mesh((1, 2), ("data", "model"))
    model2, target = abstract_train_state(cfg, opt, key=key, device="cpu", mesh=mesh2, axes=axes)
    got, _ = restore_checkpoint(task["dst"], target, device="cpu",
                                shardings=_plan(cfg, opt, key, axes, mesh2), mesh=mesh2)
    ms2 = build_train_step(model2, opt, mesh2, axes).mesh_step
    out["restored"] = {"params": ms2.whole_params(got.params),
                       "opt_state": ms2.whole_state(got.opt_state), "step": int(got.step)}
    return out


def _protocol(task, rank):
    """The commit protocol in ``dir``: a save, then one whose rank 1 dies at
    the ``ckpt_written`` seam (short rendezvous timeout), then a re-save
    interrupted between its renames that process 0 repairs while the others
    wait."""
    import torch.distributed as dist

    from repro_torch.io import CheckpointManager, restore_checkpoint, writer
    from repro_torch.io import format as fmt
    from repro_torch.sharding.rules import P

    d, mesh = task["dir"], {"data": 2, "model": 2}
    plan = {"w": P(("data", "model"))}
    # this rank's part: element ``rank`` of a 4-element leaf
    tree = lambda step: {"w": torch.full((1,), float(100 * step + rank))}
    mgr = CheckpointManager(d, keep_last=3)
    mgr.save(1, tree(1), shardings=plan, mesh=mesh, block=True)
    out = {"committed_1": fmt.is_complete(fmt.step_dir(d, 1))}
    writer._RENDEZVOUS_TIMEOUT_S = task["timeout"]
    real = writer._barrier

    def dying(name):
        if rank == 1 and name.startswith("ckpt_written"):
            raise RuntimeError("rank 1 killed between its shard write and its index")
        return real(name)

    writer._barrier = dying
    try:
        mgr.save(2, tree(2), shardings=plan, mesh=mesh)
        try:
            mgr.wait()
            out["error"] = None
        except Exception as e:  # every rank's save fails, each on its own
            out["error"] = f"{type(e).__name__}: {e}"
    finally:
        writer._barrier = real
    out["latest"] = mgr.latest_step()
    out["commit_2"] = os.path.exists(os.path.join(fmt.step_dir(d, 2), fmt.COMMIT))
    got, _ = restore_checkpoint(d, {"w": torch.empty(1, device="meta")}, device="cpu",
                                shardings=plan, mesh=mesh)
    out["restored"] = got["w"]
    dist.barrier()
    # a re-save of step 1 killed between its two renames: the committed copy
    # set aside, an incomplete step_1 in its place
    final = fmt.step_dir(d, 1)
    if rank == 0:
        os.rename(final, final + ".replaced")
        os.makedirs(final)
    dist.barrier()
    if rank == 0:
        time.sleep(task["repair_delay"])
    out["scan_t"] = time.time()
    out["repaired_latest"] = fmt.latest_step(d)
    out["return_t"] = time.time()
    return out


TASKS = {"allreduce": _allreduce, "reduce": _reduce, "step": _step, "optim": _optim,
         "optim_one": _optim_one, "losses": _losses, "tp_step": _tp_step, "tp_blocks": _tp_blocks,
         "moe_blocks": _moe_blocks, "recurrent_blocks": _recurrent_blocks,
         "fallback_blocks": _fallback_blocks, "collectives": _collectives, "slots": _slots,
         "save": _save, "restore": _restore, "resume": _resume, "mesh_ckpt": _mesh_ckpt,
         "protocol": _protocol}


def _rank(rank, world, store, tasks_file, out_dir):
    torch.set_num_threads(1)
    tasks = torch.load(tasks_file, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        from repro_torch.comms.collectives import open_host_slots

        open_host_slots()
        res = {}
        for name, t in tasks.items():
            if t.get("after"):
                deadline = time.monotonic() + 600
                while not os.path.exists(t["after"]):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"task {name}: {t['after']} never appeared")
                    time.sleep(0.05)
            res[name] = TASKS[t["kind"]](t, rank)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        from repro_torch.comms.collectives import close_host_slots

        close_host_slots()
        dist.destroy_process_group()


def start(world, tasks, tmp):
    """Start the world; ``collect`` waits for it and returns each rank's results."""
    os.makedirs(tmp, exist_ok=True)
    # the ranks read the tasks from a file: a task's arrays pickled to each
    # spawned process take seconds
    tasks_file = os.path.join(tmp, "tasks.pt")
    torch.save(tasks, tasks_file)
    ctx = mp.start_processes(_rank, args=(world, os.path.join(tmp, "store"), tasks_file, tmp),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, tmp


def collect(started, timeout=None):
    """Each rank's results; with ``timeout`` (seconds), a world still
    running then is killed and ``TimeoutError`` raised (a deadlock)."""
    ctx, world, tmp = started
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=None if deadline is None else 1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"the world of {world} ranks ran past {timeout} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def spawn(world, tasks, tmp):
    return collect(start(world, tasks, tmp))
