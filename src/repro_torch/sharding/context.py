"""The mesh context (counterpart of ``repro/sharding/context.py``): what a
rank of a ``(data, model)`` mesh knows about its place, and the tile of the
leaf that an update is working on.

The reference keeps its layouts inside one jitted program (GSPMD); the
port runs one process per rank, so each rank holds only its part of every
tensor and the code that needs the whole leaf asks this module:

* ``MeshRun``: the mesh, this rank's coordinate, and the process groups
  (the world; the data group of the ranks that share this rank's model
  coordinate: gradients are summed over it; and the model group of the
  ranks that share its data coordinates, in model-rank order: the
  tensor-parallel compute of ``sharding.tensor_parallel`` sums over it);
* ``use(run, tiles)`` makes a run and its ``{path: Tile}`` map current;
  ``leaf(path)`` marks the leaf being updated, and ``current_tile()`` gives
  its ``Tile`` (the whole leaf's shape and this rank's box) or ``None``
  off the mesh, where every caller keeps its one-device path unchanged;
  a state leaf shaped otherwise than its parameter (Shampoo's factor
  stacks) has its own tile in the map under ``(path, field)``, current
  within ``field(name)``;
* ``batch_shards(n, index, group)`` tells the model its batch is shard
  ``index`` of ``n`` data shards of the global batch, cut in data rank
  order, and gives it the data group (the MoE layer forms its token groups
  over the global batch, and exchanges the routing's counts over that
  group where a group spans shards).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

from repro_torch.sharding.rules import dp_axes, mesh_axis_sizes

__all__ = ["Tile", "MeshRun", "use", "leaf", "field", "current_run", "current_tile", "leaf_tile",
           "tile_of", "box_of", "rank_coord", "DataShards", "batch_shards",
           "current_data_shards"]

Box = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class Tile:
    """A rank's part of a leaf: the whole ``shape`` and the ``box``
    (``(start, stop)`` per dim) it holds; ``boxes``, where given, is every
    rank's box in rank order."""

    shape: Tuple[int, ...]
    box: Box
    boxes: Tuple[Box, ...] = ()

    def firsts(self) -> Tuple[int, ...]:
        """The lowest rank holding each distinct box, ascending: the ranks
        whose partials a sum over the leaf counts."""
        if not self.boxes:
            raise ValueError(f"a tile of {self.shape} without every rank's box")
        seen: Dict[Box, int] = {}
        for r, b in enumerate(self.boxes):
            seen.setdefault(b, r)
        return tuple(sorted(seen.values()))

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in self.box)

    @property
    def whole(self) -> bool:
        return all(a == 0 and b == n for (a, b), n in zip(self.box, self.shape))

    def index(self) -> Tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in self.box)


class MeshRun:
    """This process's place on a mesh of ``torch.distributed`` ranks. With
    ``rank`` given, the place of that rank of a mesh ``{axis: size}`` with
    no world: its groups are ``comms.collectives.Ranks`` (the layout
    reckoning runs the collectives ``without_world``)."""

    def __init__(self, mesh, rank: Optional[int] = None):
        import torch.distributed as dist

        from repro_torch.comms.collectives import Ranks

        self.sizes = mesh_axis_sizes(mesh)
        self.names = tuple(self.sizes)
        self.coords = [dict(zip(self.names, c))
                       for c in itertools.product(*(range(n) for n in self.sizes.values()))]
        live = rank is None
        self.rank = dist.get_rank() if live else int(rank)
        self.world = dist.get_world_size() if live else len(self.coords)
        self.coord = self.coords[self.rank]
        dps = set(dp_axes(self.sizes))
        self.n_dp = 1
        for a in dps:
            self.n_dp *= self.sizes[a]
        self.n_tp = len(self.coords) // self.n_dp
        # one data group per model coordinate and one model group per data
        # coordinate, every rank creating every group (in one order); a
        # model axis of 1 has no model groups
        self.data_group, self.data_ranks = None, None
        self.model_group, self.model_ranks = None, [self.rank]
        for is_data in (True, False):
            if not is_data and self.n_tp == 1:
                break
            pick = lambda c: tuple(c[a] for a in self.names if (a in dps) != is_data)
            for key in sorted({pick(c) for c in self.coords}):
                ranks = [r for r, c in enumerate(self.coords) if pick(c) == key]
                group = dist.new_group(ranks) if live else Ranks(ranks)
                if self.rank in ranks and is_data:
                    self.data_group, self.data_ranks = group, ranks
                elif self.rank in ranks:
                    self.model_group, self.model_ranks = group, ranks
        # this rank's place in its model group: its shard of every leaf that
        # computes tensor-parallel
        self.model_index = self.model_ranks.index(self.rank)


_RUN: contextvars.ContextVar[Optional[MeshRun]] = contextvars.ContextVar("repro_mesh_run",
                                                                         default=None)
_TILES: contextvars.ContextVar[Optional[Mapping[str, Tile]]] = contextvars.ContextVar(
    "repro_mesh_tiles", default=None)
_LEAF: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar("repro_mesh_leaf",
                                                                      default=None)
_FIELD: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar("repro_mesh_field",
                                                                       default=None)


@dataclasses.dataclass(frozen=True)
class DataShards:
    """The global batch cut into ``size`` equal shards in data rank order:
    this rank's ``index``, and the data group (a process group, a
    ``collectives.Ranks`` with no world, or None where nothing is
    exchanged); ``world`` is set where the collectives run
    ``without_world`` (the roofline on ``meta``)."""

    size: int = 1
    index: int = 0
    group: Any = None
    world: Optional[int] = None


_SHARDS: contextvars.ContextVar[DataShards] = contextvars.ContextVar("repro_batch_shards",
                                                                     default=DataShards())


@contextlib.contextmanager
def batch_shards(n: int, index: int = 0, group=None,
                 world: Optional[int] = None) -> Iterator[None]:
    """Within it, the batch the model sees is shard ``index`` of ``n`` equal
    data shards of the global batch (the mesh step's forward), ``group``
    the data group."""
    token = _SHARDS.set(DataShards(int(n), int(index), group, world))
    try:
        yield
    finally:
        _SHARDS.reset(token)


def current_data_shards() -> DataShards:
    """This rank's shard of the global batch (the one whole shard off the
    mesh)."""
    return _SHARDS.get()


@contextlib.contextmanager
def use(run: MeshRun, tiles: Mapping[str, Tile]) -> Iterator[None]:
    t1, t2 = _RUN.set(run), _TILES.set(tiles)
    try:
        yield
    finally:
        _RUN.reset(t1)
        _TILES.reset(t2)


@contextlib.contextmanager
def leaf(path: str) -> Iterator[None]:
    token = _LEAF.set(path)
    try:
        yield
    finally:
        _LEAF.reset(token)


@contextlib.contextmanager
def field(name: str) -> Iterator[None]:
    """Within it, the tensor being (de)quantized is the current leaf's
    state field ``name``: its own tile, where the map has one."""
    token = _FIELD.set(name)
    try:
        yield
    finally:
        _FIELD.reset(token)


def current_run() -> Optional[MeshRun]:
    return _RUN.get()


def leaf_tile(path: Optional[str], name: Optional[str] = None) -> Optional[Tile]:
    """The tile of ``path`` in the active map, or with ``name`` the tile of
    that state field of it (``None`` where the map has none); ``None`` off
    the mesh, and for a whole leaf."""
    tiles = _TILES.get()
    if tiles is None or path is None:
        return None
    tile = tiles.get(path if name is None else (path, name))
    return None if tile is None or tile.whole else tile


def current_tile() -> Optional[Tile]:
    """The current leaf's tile (``None`` off the mesh, or for a whole
    leaf); within ``field(name)``, that field's own tile where it has one."""
    tiles, path, name = _TILES.get(), _LEAF.get(), _FIELD.get()
    if tiles is not None and name is not None and (path, name) in tiles:
        return leaf_tile(path, name)
    return leaf_tile(path)


def tile_of(path: str) -> Tile:
    """The active map's tile of ``path`` (whole or not)."""
    return _TILES.get()[path]


def box_of(spec, shape, run: MeshRun) -> Box:
    """This rank's box of a ``shape`` tensor under ``spec``."""
    from repro_torch.sharding.specs import local_box

    return local_box(spec, tuple(shape), run.coord, run.sizes)


def rank_coord(mesh) -> Dict[str, int]:
    """This process's coordinate on ``mesh`` (its ranks row-major)."""
    import torch.distributed as dist

    from repro_torch.sharding.specs import mesh_coords

    return mesh_coords(mesh)[dist.get_rank()]
