"""Ranks of the port's mesh tests (imported by spawned processes; torch only).

``spawn(world, tasks, tmp)`` starts ``world`` gloo processes that meet
through a ``FileStore`` in ``tmp`` (never a fixed port), runs every task
in every rank, and returns each rank's results (``start`` and ``collect``
split it, so the caller can work while the ranks run). A task is a dict with a
``kind`` (``allreduce``, ``reduce``, ``step``, ``losses``) and its inputs; each rank
runs on one CPU thread (pytest runs several workers at once).
"""

import os

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
    return out


def _losses(task, rank):
    """End-to-end losses of the mesh step from ``init_model(seed=0)``."""
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
    model = init_model(cfg, seed=0, device="cpu")
    opt = make_optimizer(task["optimizer"], task["lr"])
    state = shard_train_state(make_train_state(model, opt, key=sr.PRNGKey(task["sr_seed"])),
                              mesh, axes)
    fn = build_train_step(model, opt, mesh, axes)
    out = []
    for batch in task["batches"]:
        state, metrics = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        out.append((float(metrics["loss"]), float(metrics["aux_loss"])))
    return out


TASKS = {"allreduce": _allreduce, "reduce": _reduce, "step": _step, "losses": _losses}


def _rank(rank, world, store, tasks, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        res = {name: TASKS[t["kind"]](t, rank) for name, t in tasks.items()}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(world, tasks, tmp):
    """Start the world; ``collect`` waits for it and returns each rank's results."""
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_rank, args=(world, os.path.join(tmp, "store"), tasks, tmp),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, tmp


def collect(started):
    ctx, world, tmp = started
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def spawn(world, tasks, tmp):
    return collect(start(world, tasks, tmp))
