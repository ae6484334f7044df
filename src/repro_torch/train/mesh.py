"""The train step on a ``(data, model)`` mesh of processes: the mesh half of
``repro/train/train_loop.py`` (``train_state_shardings`` and the layouts of
``jit_train_step``) and the counterpart of ``repro/sharding/context.py``'s
per-layer constraint.

The reference partitions one jitted step with GSPMD. Here every rank is a
process that holds only its part of each tensor, as the plans say
(``sharding.specs``): its tile of every parameter (``spec_for`` + ZeRO),
of every fp32 moment, of the packed codes, and its part of the scales.

* Forward: the ranks of one model group (one data coordinate) compute one
  batch shard together, tensor-parallel on the ``model`` axis
  (``sharding.tensor_parallel``, the reference's ``TP_RULES`` split): each
  computes its heads (or, where the axis does not divide them, its rows)
  of every attention, its columns of every MLP, its experts (or each
  expert's columns) of every MoE layer, its heads, states or rows of every
  recurrent block and its vocab rows (or its columns of the model's width)
  of the lookup and the cross entropy, where the plan cuts those leaves on
  ``model`` (``placement``), and the partial results are summed (the
  experts' outputs and column-cut products gathered) over the model group
  in ascending model rank. Such a leaf is gathered over the rank's data
  group only, into its model shard (with one data rank, the shard is the
  rank's own part: no collective); every other leaf (norms, the MoE
  router, hymba's scales, the kv weights of a head-parallel attention
  whose kv heads the axis does not divide, an MLP or experts whose widths
  the axis does not divide) is gathered whole over the world and computed
  alike on every rank of the group. An MoE layer groups the global batch's tokens:
  where a group spans data shards, its routing counts are exchanged over
  the data group (``models.moe``).
  Top-level leaves (embed, head, final norms) are gathered before the
  forward; a stacked leaf one layer at a time, when the layer loop
  reaches that layer (``unit_layers``, the hook of
  ``models.model._run_units``), and under ``cfg.remat`` once more when the
  backward recomputes that layer, so a rank holds one gathered layer at a
  time, as a ZeRO layer under ``jax.checkpoint`` does.
* Backward: each gathered tensor's gradient (of the model shard, or of the
  whole leaf, which every rank of the model group computes alike) goes
  straight to its owners (``all_to_all`` inside the data group: every rank
  receives the gradient of its own tile from each data shard) and is
  summed in ascending data rank order, then divided by the data size; no
  rank holds a whole-model gradient.
* Update: the optimizer runs on the tiles inside ``sharding.context``, so
  the 4-bit statistics, the SR draws and the fused kernel's counters are
  the whole leaf's (``core.quantizer``, ``kernels.ops``). Moments whose
  plan cuts them differently from the parameter (the ZeRO dim of a raw
  moment may be a dim the parameter's rules skip; packed codes may lose an
  assignment) are moved to the parameter's tile first and back after;
  scales are all-gathered whole and cut back to the plan's part after. A
  leaf the fused kernel may take whose tiles cut its B128 blocks (the
  kernel needs whole blocks per tile row), or a leaf with 4-bit moments
  whose tiles cut a packed byte of codes (two columns a byte), is updated
  on tiles of whole rows instead: its parameter, gradient and moments move
  there and back.

Every optimizer of the repo runs here. A state leaf moves by its own
shape and plan: SM3's accumulators and the factored moments are
replicated and pass through (the rules read the tile's ranges of them and
merge their new values over the ranks, ``core.optimizers.transform``);
Shampoo's factor stacks are updated on ranges of whole blocks, those of
the stacks' plan where it cuts dim 0, else ranges the step chooses (the
greatest common divisor of the block count and the world size of equal
ranges), each stack's tile in the context under ``(path, field)``.

``MeshStep.reckon`` walks the same code with no world (a ``MeshRun`` made
for one rank of an ``{axis: size}`` mesh, ``meta`` parts, the collectives
``without_world``), and the model group's sums of the tensor-parallel
compute and the MoE layers' data-group exchanges per layer and
microbatch (``tensor_parallel.reckon_sums``): it
gives one step's collective bytes as ``STATS`` counts them and the calls
the roofline prices, for any mesh.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.comms import CommsConfig, grad_comm_key, reduce_grads
from repro_torch.comms.collectives import (
    STATS,
    all_gather,
    all_to_all,
    recording,
    timed,
    without_world,
)
from repro_torch.core.optimizers.base import FactoredMoment
from repro_torch.core.optimizers.transform import ChainState, PartitionState
from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.kernels import sr
from repro_torch.sharding import context
from repro_torch.sharding import tensor_parallel as tp_lib
from repro_torch.sharding.context import MeshRun, Tile
from repro_torch.sharding.rules import P, spec_for, with_zero
from repro_torch.sharding.specs import (
    batch_shardings,
    box_index,
    local_box,
    local_slice,
    map_plan,
    opt_state_shardings,
)

__all__ = ["MeshStep", "STATS"]

Box = Tuple[Tuple[int, int], ...]


_LEAF_TYPES = (torch.Tensor, QuantizedTensor, FactoredMoment)
# the metrics forward_backward averages over the data shards (params_loss's
# two and the loss)
_METRICS = ("aux_loss", "ce_loss", "loss")


@functools.lru_cache(maxsize=4096)
def _grid(boxes: Tuple[Box, ...], shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(the first rank holding each cell, cells per dim): the boxes of a
    plan cut every dim into equal cells that together cover the tensor
    (ranks that replicate a cell hold equal pieces); cells in row-major
    order."""
    steps = [b - a for a, b in boxes[0]]
    cell = [st or 1 for st in steps]  # an empty dim is one cell
    counts = [int(n) // c if st else 1 for st, c, n in zip(steps, cell, shape)]
    first: Dict[Tuple[int, ...], int] = {}
    for r, box in enumerate(boxes):
        if any(b - a != st or a % c for (a, b), st, c in zip(box, steps, cell)):
            raise ValueError(f"boxes {boxes} do not cut {tuple(shape)} into equal cells")
        first.setdefault(tuple(a // c for (a, _), c in zip(box, cell)), r)
    if len(first) != math.prod(counts) or any(c * st != n for c, st, n in
                                              zip(counts, steps, shape)):
        raise ValueError(f"boxes {boxes} do not cover {tuple(shape)}")
    return tuple(first[c] for c in sorted(first)), tuple(counts)


def _assemble(pieces: torch.Tensor, boxes: List[Box], shape) -> torch.Tensor:
    """The whole tensor from the ranks' pieces: one gather of the cells in
    row-major order and one copy into place."""
    order, counts = _grid(tuple(boxes), tuple(shape))
    if order != tuple(range(pieces.shape[0])):
        pieces = pieces.index_select(0, torch.tensor(order, device=pieces.device))
    nd = len(counts)
    cells = pieces.reshape(*counts, *pieces.shape[1:])
    return cells.permute([i for d in range(nd) for i in (d, nd + d)]).reshape(tuple(shape))


def _whole(boxes: List[Box], shape) -> bool:
    return all(a == 0 and b == n for box in boxes for (a, b), n in zip(box, shape))


def gather(local: torch.Tensor, boxes: List[Box], shape, group=None) -> torch.Tensor:
    """The whole tensor from every rank's box (``boxes`` in the rank order
    of ``group``, the world if None)."""
    if _whole(boxes, shape):
        return local
    return _assemble(timed(all_gather, local, group), boxes, shape)


def reshard(x: torch.Tensor, shape, src: List[Box], dst: List[Box], rank: int) -> torch.Tensor:
    """This rank's ``dst`` box from the ranks' ``src`` boxes."""
    if src == dst:
        return x
    inside = all(sa <= da and db <= sb
                 for s, d in zip(src, dst) for (sa, sb), (da, db) in zip(s, d))
    if inside:  # every rank cuts its part from what it holds
        return x[tuple(slice(da - sa, db - sa) for (sa, _), (da, db) in zip(src[rank], dst[rank]))
                 ].clone()
    return gather(x, src, shape)[box_index(dst[rank])].clone()


class _Gathered(torch.autograd.Function):
    """Forward: ``gather()``; backward: the gradient goes to ``sink``, not
    down the graph. ``anchor`` is a 0-d leaf that requires grad, so autograd
    runs the backward."""

    @staticmethod
    def forward(ctx, anchor, gather_fn, sink):
        ctx.sink = sink
        return gather_fn().detach()

    @staticmethod
    def backward(ctx, grad):
        ctx.sink(grad)
        return None, None, None


class _Stack:
    """One stack's layers, each gathered when the layer loop asks for it."""

    def __init__(self, step: "MeshStep", entries: List[Tuple[str, str]]):
        self.step, self.entries = step, entries

    def __getitem__(self, r: int) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        for rel, path in self.entries:
            *dirs, name = rel.split("/")
            node = tree
            for d in dirs:
                node = node.setdefault(d, {})
            node[name] = self.step._gathered(path, r)
        return tree


def _cuts_blocks(boxes: List[Box], shape, block: int = 128) -> bool:
    """Whether a leaf the fused route may take (ndim >= 2, last dim % 256 ==
    0) has tiles whose columns cut its B128 blocks."""
    if len(shape) < 2 or shape[-1] % 256:
        return False
    return any(b[-1][0] % block or (b[-1][1] - b[-1][0]) % block for b in boxes)


def _block_rows(boxes: List[Box], shape, world: int) -> List[Box]:
    """Tiles of whole rows for such a leaf: the first dim, from the rows
    back, that the world divides is cut; else every rank takes the whole
    leaf."""
    whole = tuple((0, int(n)) for n in shape)
    for d in range(len(shape) - 2, -1, -1):
        if shape[d] % world == 0:
            step = shape[d] // world
            return [whole[:d] + ((r * step, (r + 1) * step),) + whole[d + 1:]
                    for r in range(world)]
    return [whole] * world


def _splits_bytes(boxes: List[Box], shape) -> bool:
    """Whether some tile cuts the last dim inside a packed byte of 4-bit
    codes (two columns a byte; an odd last dim's final byte holds one)."""
    return any(b[-1][0] % 2 or (b[-1][1] % 2 and b[-1][1] != shape[-1]) for b in boxes)


def _halve_last(box: Box, last: int) -> Box:
    """The packed codes' box of a tile of a leaf whose last dim is ``last``."""
    (a, b) = box[-1]
    if a % 2 or (b % 2 and b != last):
        raise ValueError(f"a tile {box} splits a packed byte of 4-bit codes")
    return box[:-1] + ((a // 2, (b + 1) // 2),)


class MeshStep:
    """Layouts and the step of one run: ``run`` (``sharding.context.MeshRun``),
    the whole model's ``shapes`` and ``axes``, and the optimizer's whole
    state on the ``meta`` device (``meta_state``) for its plan."""

    def __init__(self, run: MeshRun, cfg, shapes: Mapping[str, Tuple[int, ...]],
                 axes: Mapping[str, Tuple[str, ...]], meta_params, meta_state, zero: bool = True):
        self.run, self.cfg, self.axes = run, cfg, dict(axes)
        self.shapes = {k: tuple(int(d) for d in s) for k, s in shapes.items()}
        sizes = run.sizes
        self.param_plan = {}
        for k, shape in self.shapes.items():
            spec = spec_for(shape, axes[k], sizes)
            self.param_plan[k] = with_zero(shape, spec, sizes, axes=axes[k]) if zero else spec
        self.boxes = {k: [local_box(self.param_plan[k], s, c, sizes) for c in run.coords]
                      for k, s in self.shapes.items()}
        self.tiles = {k: Tile(s, self.boxes[k][run.rank], tuple(self.boxes[k]))
                      for k, s in self.shapes.items()}
        # the update's layout: the parameter's tile, unless that cuts the B128
        # blocks of a leaf the fused kernel may take (it needs whole blocks
        # per tile row), or a packed byte of a 4-bit moment's codes; such a
        # leaf is updated on row tiles instead
        packed = {k for k, _, v in _mirror_leaves(meta_state, self.shapes)
                  if isinstance(v, QuantizedTensor) and v.config.bits == 4}
        self.work = {k: _block_rows(b, s, run.world)
                     if _cuts_blocks(b, s) or (k in packed and _splits_bytes(b, s)) else b
                     for (k, b), s in zip(self.boxes.items(), self.shapes.values())}
        self.work_tiles: Dict[Any, Tile] = {k: Tile(s, self.work[k][run.rank], tuple(self.work[k]))
                                            for k, s in self.shapes.items()}
        self.state_plan = opt_state_shardings(meta_state, meta_params, axes, sizes, zero)
        # (whole shape, partition) at every tensor of the state
        self.state_shapes = map_plan(lambda t, p: (tuple(t.shape), p), meta_state,
                                     self.state_plan)
        # state leaves shaped otherwise (Shampoo's factor stacks): their own
        # work boxes, ranges of whole blocks on dim 0, keyed (path, field)
        self.stack_work = self._stack_work()
        for (k, f), boxes in self.stack_work.items():
            self.work_tiles[(k, f)] = Tile(_box_shape(boxes), boxes[run.rank], tuple(boxes))
        self._grads: Dict[str, torch.Tensor] = {}
        self._written: set = set()
        # the leaves that compute tensor-parallel (their model-cut dim) and
        # the rank's model group
        self.split = tp_lib.placement(self.shapes, self.axes, sizes)
        self.tp = (tp_lib.TPRun(run.model_group, run.model_index, run.n_tp)
                   if any(d is not None for d in self.split.values()) else None)
        # this rank's shard of the global batch, in data rank order; an MoE
        # layer may exchange over the data group where its groups span shards
        self._data_index = run.data_ranks.index(run.rank)
        self._needs_batch = self.tp is not None or (
            run.n_dp > 1 and any(k.endswith("/moe/router") for k in self.shapes))

    def _stack_work(self) -> Dict[Tuple[str, str], List[Box]]:
        """The block ranges of every state leaf whose shape is not its
        parameter's: those of a stack of the leaf whose plan cuts dim 0,
        else ``gcd(blocks, world)`` equal ranges (rank ``r`` takes range
        ``r // (world / ranges)``)."""
        stacks: Dict[str, Dict[str, Tuple[Tuple[int, ...], List[Box]]]] = {}
        for k, f, sp in _mirror_leaves(self.state_shapes, self.shapes):
            if isinstance(sp, QuantizedTensor):
                shape, plan = tuple(sp.shape), self.plan_boxes(*sp.codes)
            elif isinstance(sp, tuple) and len(sp) == 2 and isinstance(sp[1], P):
                shape, plan = sp[0], self.plan_boxes(*sp)
            else:  # factored moments, SM3's accumulator tuples: replicated
                continue
            if shape != self.shapes[k] and math.prod(shape) > 0:
                stacks.setdefault(k, {})[f] = (shape, plan)
        world, out = self.run.world, {}
        for k, by_field in stacks.items():
            nb = next(iter(by_field.values()))[0][0]
            cut = [p for _, p in by_field.values() if any(b[0] != (0, nb) for b in p)]
            if cut:
                ranges = [b[0] for b in cut[0]]
            else:
                n = math.gcd(nb, world)
                ranges = [((r // (world // n)) * (nb // n), (r // (world // n) + 1) * (nb // n))
                          for r in range(world)]
            for f, (shape, _) in by_field.items():
                out[(k, f)] = [(rg,) + tuple((0, d) for d in shape[1:]) for rg in ranges]
        return out

    # -- layouts ------------------------------------------------------------

    def plan_boxes(self, shape, spec) -> List[Box]:
        return [local_box(spec, shape, c, self.run.sizes) for c in self.run.coords]

    def _convert(self, tree, sp, to_work: bool, field: Optional[str] = None):
        if (isinstance(tree, dict) and tree and all(k in self.shapes for k in tree)
                and all(isinstance(v, _LEAF_TYPES) for v in tree.values())):
            return {k: self._convert_leaf(k, v, sp[k], to_work, field) for k, v in tree.items()}
        if isinstance(tree, ChainState):
            return ChainState(self._convert(s, p, to_work) for s, p in zip(tree.states, sp.states))
        if isinstance(tree, PartitionState):
            return PartitionState({k: self._convert(tree.states[k], sp.states[k], to_work)
                                   for k in tree.states}, tree.param_paths)
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(self._convert(s, p, to_work, f)
                                for s, p, f in zip(tree, sp, tree._fields)))
        if isinstance(tree, dict):
            return {k: self._convert(v, sp[k], to_work, field) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self._convert(s, p, to_work, field) for s, p in zip(tree, sp))
        return tree  # step counters and other replicated leaves

    def _convert_leaf(self, k: str, v, sp, to_work: bool, field: Optional[str]):
        """One state leaf between its plan and the update's layout, by its
        own shape: a parameter-shaped leaf on the parameter's work tile, a
        factor stack on its block range; factored moments and empty
        placeholders are replicated and pass through."""
        if isinstance(v, FactoredMoment):
            return v
        rank = self.run.rank
        whole = tuple(sp.shape) if isinstance(v, QuantizedTensor) else sp[0]
        if whole == self.shapes[k]:
            work, tile = self.work[k], self.work_tiles[k]
        elif (k, field) in self.stack_work:
            work, tile = self.stack_work[(k, field)], self.work_tiles[(k, field)]
        else:
            return v
        if isinstance(v, QuantizedTensor):
            cshape, cspec = sp.codes
            cwork = [_halve_last(b, whole[-1]) for b in work] if v.config.bits == 4 else work
            cplan = self.plan_boxes(cshape, cspec)
            src, dst = (cplan, cwork) if to_work else (cwork, cplan)
            codes = reshard(v.codes, cshape, src, dst, rank)
            scales = []
            for s, (sshape, sspec) in zip(v.scales, sp.scales):
                boxes = self.plan_boxes(sshape, sspec)
                scales.append(gather(s, boxes, sshape) if to_work
                              else s[box_index(boxes[rank])].clone())
            shape = tile.local_shape if to_work else whole
            return QuantizedTensor(codes, tuple(scales), shape, v.config)
        shape, spec = sp
        plan = self.plan_boxes(shape, spec)
        return reshard(v, shape, plan, work, rank) if to_work else reshard(v, shape, work, plan,
                                                                            rank)

    def to_work(self, opt_state):
        """Plan layout -> the update's working layout (every moment on the
        update's tile of its parameter, whole scales)."""
        return self._convert(opt_state, self.state_shapes, True)

    def to_plan(self, opt_state):
        return self._convert(opt_state, self.state_shapes, False)

    def update(self, optimizer, grads, opt_state, params, key=None):
        """The optimizer's update on this rank's tiles: ``params`` (tiles) are
        updated in place; returns the new state in the plan layout."""
        rank = self.run.rank
        moved = [k for k in params if self.work[k] != self.boxes[k]]
        to_rows = lambda k, x: reshard(x, self.shapes[k], self.boxes[k], self.work[k], rank)
        wp = {k: to_rows(k, p) if k in moved else p for k, p in params.items()}
        wg = {k: to_rows(k, g) if k in moved else g for k, g in grads.items()}
        work = self.to_work(opt_state)
        with context.use(self.run, self.work_tiles):
            _, new_work = optimizer.update(wg, work, wp, key=key)
        del work, wg
        for k in moved:
            params[k].copy_(reshard(wp[k], self.shapes[k], self.work[k], self.boxes[k], rank))
        return self.to_plan(new_work)

    def whole_params(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every parameter whole, from the ranks' tiles (every rank)."""
        return {k: gather(p, self.boxes[k], self.shapes[k]).clone() for k, p in params.items()}

    def whole_state(self, opt_state):
        """The optimizer state whole, from the ranks' parts (every rank)."""
        return map_plan(lambda t, sp: gather(t, self.plan_boxes(*sp), sp[0]).clone(), opt_state,
                        self.state_shapes)

    # -- forward / backward ---------------------------------------------------

    def _sink(self, path: str, r: Optional[int], boxes: List[Box]) -> Callable:
        """The gradient's way to its owners: ``boxes`` are the data group's
        boxes (in its order) inside the gathered tensor."""
        run = self.run

        def sink(g: torch.Tensor) -> None:
            pieces = torch.stack([g[box_index(b)] for b in boxes])
            recv = timed(all_to_all, pieces, run.data_group)
            acc = recv[0].clone()
            for d in range(1, recv.shape[0]):  # ascending data rank
                acc += recv[d]
            if run.n_dp > 1:
                acc = acc / torch.full((), float(run.n_dp), dtype=acc.dtype, device=acc.device)
            buf = self._grads[path] if r is None else self._grads[path][r]
            key = (path, r)
            if key in self._written:
                buf += acc
            else:
                buf.copy_(acc)
                self._written.add(key)

        return sink

    def _layout(self, path: str, r: Optional[int]):
        """What the forward gathers of a top-level leaf (``r`` None) or of
        layer ``r`` of a stacked one: (this rank's part, the boxes of the
        gather's group in its order, the gathered shape, the group (None:
        the world), the data group's boxes inside the gathered tensor). A
        leaf that computes tensor-parallel is gathered over the data group
        into the rank's model shard, any other whole over the world."""
        run = self.run
        local = self._params[path] if r is None else self._params[path][r]
        boxes = self.boxes[path] if r is None else [b[1:] for b in self.boxes[path]]
        dim = self.split[path]
        if dim is None:
            shape = self.shapes[path] if r is None else self.shapes[path][1:]
            return local, boxes, shape, None, [boxes[j] for j in run.data_ranks]
        mbox = tp_lib.model_box(self.shapes[path], dim, run.model_index, run.n_tp)
        mbox = mbox if r is None else mbox[1:]
        rel = [tuple((a - m, b - m) for (a, b), (m, _) in zip(boxes[j], mbox))
               for j in run.data_ranks]
        return local, rel, tuple(b - a for a, b in mbox), run.data_group, rel

    def _gathered(self, path: str, r: Optional[int] = None) -> torch.Tensor:
        local, boxes, shape, group, sink_boxes = self._layout(path, r)
        return _Gathered.apply(self._anchor, lambda: gather(local.detach(), boxes, shape, group),
                               self._sink(path, r, sink_boxes))

    def unit_layers(self, units, root: str):
        out = []
        for ui, unit in enumerate(units):
            subs = []
            for si in range(len(unit.pattern)):
                prefix = f"{root}/{ui}/sub{si}/"
                entries = [(k[len(prefix):], k) for k in self.shapes if k.startswith(prefix)]
                subs.append(_Stack(self, entries))
            out.append(subs)
        return out

    def forward_backward(self, params: Mapping[str, torch.Tensor], batch, accum_steps: int):
        """Loss and metrics of this rank's batch shard, averaged over the data
        shards; leaves this rank's gradient tiles in ``self._grads``."""
        from repro_torch.models.model import params_loss
        from repro_torch.train.train_loop import _microbatch

        local, shards = self._local_batch(batch)
        self._params = params
        self._grads = {k: torch.empty_like(p) for k, p in params.items()}
        self._written = set()
        losses, mets = [], []
        for i in range(accum_steps):
            micro = ({k: _microbatch(v, i, accum_steps) for k, v in local.items()}
                     if accum_steps > 1 else local)
            self._anchor = torch.zeros((), requires_grad=True)
            top = {k: self._gathered(k) for k in self.shapes
                   if not k.startswith(("decoder/", "encoder/"))}
            with context.batch_shards(shards, self._data_index, self.run.data_group), \
                    tp_lib.use(self.tp):
                loss, m = params_loss(top, self.cfg, micro, self.unit_layers)
            loss.backward()
            del top
            losses.append(loss.detach())
            mets.append(m)
        grads = self._grads
        if accum_steps > 1:
            n = torch.full((), float(accum_steps), dtype=torch.float32)
            grads = {k: g / n.to(g.device) for k, g in grads.items()}
        self._grads, self._params, self._anchor = {}, None, None
        metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        metrics["loss"] = torch.stack(losses).mean()
        return grads, self._data_mean(metrics)

    def _local_batch(self, batch):
        """(this rank's data shard of the global batch, the number of data
        shards: 1 where the batch is not cut)."""
        run = self.run
        plan = batch_shardings(batch, run.sizes)
        local = {k: local_slice(v, plan[k], run.coord, run.sizes) for k, v in batch.items()}
        shards = run.n_dp if any(any(e is not None for e in sp) for sp in plan.values()) else 1
        return local, shards

    @torch.no_grad()
    def reckon(self, params: Mapping[str, torch.Tensor], opt_state, optimizer, key=None,
               accum_steps: int = 1, comms=None, around_update=None,
               batch=None) -> Tuple[int, List[Tuple[str, int, int]]]:
        """One train step's collectives on this rank, walked with no world:
        ``params`` and ``opt_state`` are the rank's parts (``meta`` is
        enough), the run one made with ``MeshRun(mesh, rank=)``. Every
        gather and gradient exchange of ``forward_backward`` (each gathered
        tensor's gradient an empty tensor of its shape; under ``cfg.remat``
        each layer's gather twice, the recompute's too), the model group's
        sums of the tensor-parallel compute and the MoE layers' data-group
        exchanges (``batch``, the global batch, ``meta`` is enough, gives
        their shapes; needed where the step splits compute or the model
        has MoE layers) and the metrics' gather run as the step runs them;
        then ``finish`` at step 0 with
        ``optimizer``, ``key`` and the wire format ``comms`` (fp32 if None),
        inside ``around_update`` (a context manager) if given. On ``meta`` it
        runs inside a ``roofline.measured.Counter``, which stands in for B1's
        passes and for masks that depend on values. Returns (the bytes
        ``STATS["bytes"]`` counts, the calls ``collectives.recording``
        records); ``STATS`` is left as it was."""
        from repro_torch.models import layers
        from repro_torch.train.train_loop import _microbatch

        if self._needs_batch and batch is None:
            raise ValueError("the step splits compute over the model axis or groups an MoE "
                             "layer's tokens over the data shards: reckon needs the batch")
        saved = dict(STATS)
        STATS["collective_s"], STATS["bytes"] = 0.0, 0
        try:
            with without_world(self.run.world), recording() as calls:
                self._params, self._written = params, set()
                self._grads = {k: torch.empty_like(p) for k, p in params.items()}
                local_batch, shards = (self._local_batch(batch) if self._needs_batch
                                       else (None, 1))
                for i in range(accum_steps):
                    for k, shape in self.shapes.items():
                        stacked = k.startswith(("decoder/", "encoder/"))
                        for r in range(shape[0]) if stacked else (None,):
                            local, boxes, whole, group, sink_boxes = self._layout(k, r)
                            # under remat the backward gathers each layer again
                            for _ in range(2 if stacked and self.cfg.remat else 1):
                                full = gather(local, boxes, whole, group)
                            self._sink(k, r, sink_boxes)(torch.empty_like(full))
                    if self._needs_batch:
                        micro = {k: _microbatch(v, i, accum_steps)
                                 for k, v in local_batch.items()}
                        groups = {"model": self.run.model_group, "data": self.run.data_group}
                        for t, g in tp_lib.reckon_sums(self.cfg, self.split, self.shapes, micro,
                                                       layers.COMPUTE_DTYPE, self.run.n_tp,
                                                       (shards, self._data_index)):
                            timed(all_gather, t, groups[g])
                grads, self._grads, self._params = self._grads, {}, None
                dev = next(iter(params.values())).device
                self._data_mean({k: torch.zeros((), device=dev) for k in _METRICS})
                with around_update or contextlib.nullcontext():
                    self.finish(optimizer, grads, opt_state, dict(params), key, 0,
                                comms or CommsConfig())
            return int(STATS["bytes"]), list(calls)
        finally:
            STATS.update(saved)

    @torch.no_grad()
    def finish(self, optimizer, grads, opt_state, params, key, step: int, comms: CommsConfig):
        """The step after the backward: the wire format ``comms`` on this
        rank's wire tiles (SR keyed ``grad_comm_key(key, step)``), the
        optimizer's update (keyed ``fold_in(key, step)``; ``params`` updated
        in place) and the gradient norm -> (the new state in the plan
        layout, the norm)."""
        if comms.compresses:
            ck = (grad_comm_key(key, step)
                  if comms.quantized and comms.stochastic_rounding else None)
            with context.use(self.run, self.tiles):
                grads = reduce_grads(grads, self.axes, self.run.sizes, comms, key=ck)
        step_key = sr.fold_in(key, step) if key is not None else None
        new_opt = self.update(optimizer, grads, opt_state, params, key=step_key)
        return new_opt, self.grad_norm(grads)

    def _data_mean(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric averaged over the data shards, in data rank order."""
        names = sorted(metrics)
        vec = torch.stack([metrics[k].to(torch.float32) for k in names])
        allv = timed(all_gather, vec)[self.run.data_ranks]
        mean = allv.sum(dim=0) / len(self.run.data_ranks)
        return {k: mean[i] for i, k in enumerate(names)}

    def grad_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares over every leaf, each distinct tile
        counted once (the first rank holding it)."""
        rank = self.run.rank
        parts = []
        for k, g in grads.items():
            boxes = self.boxes[k]
            first = boxes.index(boxes[rank]) == rank
            sq = torch.sum(g.to(torch.float32) ** 2)
            parts.append(sq if first else torch.zeros_like(sq))
        allp = timed(all_gather, torch.stack(parts))
        return torch.sqrt(allp.sum(dim=0).sum())


def _mirror_leaves(node, shapes: Mapping[str, Tuple[int, ...]], field: Optional[str] = None):
    """``(path, field, leaf)`` of every subtree of a state that mirrors the
    params (a ``{path: leaf}`` mapping over parameter paths; ``field`` the
    name of the nearest named field above it)."""
    if isinstance(node, dict) and node and all(k in shapes for k in node):
        for k, v in node.items():
            yield k, field, v
        return
    if isinstance(node, ChainState):
        node = node.states
    elif isinstance(node, PartitionState):
        node = list(node.states.values())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            yield from _mirror_leaves(v, shapes, f)
        return
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, (tuple, list)):
        for v in node:
            yield from _mirror_leaves(v, shapes, field)


def _box_shape(boxes: List[Box]) -> Tuple[int, ...]:
    """The whole shape that boxes starting at 0 cover."""
    return tuple(max(b[d][1] for b in boxes) for d in range(len(boxes[0])))
