"""Plans for params, optimizer states, batches and caches (port of
``repro/sharding/specs.py``), and what a rank owns under a plan.

A plan mirrors a tree of the port (a ``{path: tensor}`` mapping, an
optimizer state of ``ChainState`` / ``PartitionState`` / NamedTuple nodes,
a batch) with a partition ``P`` in place of every tensor; a
``QuantizedTensor`` gets one for its codes and one per scale, a
``FactoredMoment`` one for each factor. The state walker follows the
reference's rules:

* a subtree that mirrors the params (a ``{path: leaf}`` mapping over
  parameter paths) is laid out like them: a raw moment takes the
  parameter's partition plus ZeRO; packed 4-bit codes take the parameter's
  partition with the assignments the halved last dim no longer divides
  dropped (``_sanitize_spec``), plus ZeRO; a 1-d scale of at least 65,536
  elements that the data size divides is ZeRO-sharded and every other scale
  replicated; a ``FactoredMoment`` is replicated; a leaf whose shape is not
  the parameter's (Shampoo's factor stacks) has no partition of its own and
  is ZeRO-sharded only;
* step counters and everything else are replicated.

``local_box`` gives, for a partition, a mesh coordinate and a shape, the
``(start, stop)`` range of every dim that the rank at that coordinate owns
(a dim over several mesh axes is cut in the axes' order, the first one
outermost); ``mesh_coords`` lists every rank's coordinate, ``whole_shape``
inverts a box's shape, ``local_slice`` cuts a tensor to its box and
``plan_nbytes`` sums a rank's bytes over a tree.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Mapping, Tuple

import torch

from repro_torch.core.optimizers.base import FactoredMoment
from repro_torch.core.optimizers.transform import ChainState, PartitionState
from repro_torch.core.quantizer import QuantizedTensor
from repro_torch.sharding.rules import P, dp_axes, dp_size, mesh_axis_sizes, spec_for, with_zero

__all__ = [
    "param_shardings",
    "opt_state_shardings",
    "batch_shardings",
    "cache_shardings",
    "replicated",
    "local_box",
    "mesh_coords",
    "whole_shape",
    "local_slice",
    "plan_leaves",
    "map_plan",
    "plan_nbytes",
]

Box = Tuple[Tuple[int, int], ...]


def replicated(mesh=None) -> P:
    return P()


def param_shardings(params: Mapping[str, Any], axes: Mapping[str, Tuple[str, ...]], mesh,
                    zero: bool = False) -> Dict[str, P]:
    """``{path: P}``: each parameter's tensor-parallel partition; ``zero``
    adds the data axes on its largest free dim (ZeRO-3 style masters)."""
    out = {}
    for k, p in params.items():
        spec = spec_for(tuple(p.shape), axes[k], mesh)
        out[k] = with_zero(tuple(p.shape), spec, mesh, axes=axes[k]) if zero else spec
    return out


def _sanitize_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop axis assignments whose dim is no longer divisible (packed 4-bit
    codes halve the last dim)."""
    sizes = mesh_axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for d, e in enumerate(entries):
        if e is None:
            continue
        k = 1
        for n in (e if isinstance(e, tuple) else (e,)):
            k *= sizes[n]
        if shape[d] % k:
            entries[d] = None
    return P(*entries)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _state_leaf_plan(param, axes, leaf, mesh, zero: bool):
    p_spec = spec_for(tuple(param.shape), axes, mesh)
    mirrors = tuple(getattr(leaf, "shape", ())) == tuple(param.shape)
    if isinstance(leaf, QuantizedTensor):
        codes_shape = tuple(leaf.codes.shape)
        codes = _sanitize_spec(p_spec if mirrors else P(), codes_shape, mesh)
        if zero:
            codes = with_zero(codes_shape, codes, mesh)
        scales = []
        for s in leaf.scales:
            if (zero and s.numel() >= 1 << 16 and s.dim() == 1
                    and s.shape[0] % dp_size(mesh) == 0):
                scales.append(with_zero(tuple(s.shape), P(), mesh))
            else:
                scales.append(P())
        return QuantizedTensor(codes, tuple(scales), leaf.shape, leaf.config)
    if isinstance(leaf, FactoredMoment):
        return FactoredMoment(P(), P(), leaf.shape)
    if not mirrors and (leaf.numel() == 0 or not zero):
        return P()
    if zero:
        return with_zero(tuple(leaf.shape), p_spec if mirrors else P(), mesh)
    return p_spec


_LEAF = (torch.Tensor, QuantizedTensor, FactoredMoment)


def opt_state_shardings(opt_state, params: Mapping[str, Any], axes, mesh, zero: bool = True):
    """The plan of any optimizer state of the port (see the module doc)."""

    def walk(sub):
        if sub is None:
            return None
        if (isinstance(sub, dict) and all(k in params for k in sub)
                and all(isinstance(v, _LEAF) for v in sub.values())):
            return {k: _state_leaf_plan(params[k], axes[k], v, mesh, zero) for k, v in sub.items()}
        if isinstance(sub, ChainState):
            return ChainState(walk(s) for s in sub.states)
        if isinstance(sub, PartitionState):
            return PartitionState({lab: walk(s) for lab, s in sub.states.items()},
                                  sub.param_paths)
        if isinstance(sub, tuple) and hasattr(sub, "_fields"):
            return type(sub)(*(walk(v) for v in sub))
        if isinstance(sub, dict):
            return {k: walk(v) for k, v in sub.items()}
        if isinstance(sub, (tuple, list)):
            return type(sub)(walk(v) for v in sub)
        if isinstance(sub, QuantizedTensor):  # outside a mirror: replicated
            return QuantizedTensor(P(), tuple(P() for _ in sub.scales), sub.shape, sub.config)
        if isinstance(sub, FactoredMoment):
            return FactoredMoment(P(), P(), sub.shape)
        return P()  # step counters and other scalars / tensors

    return walk(opt_state)


def _batch_dim(x) -> int:
    # M-RoPE positions are (3, B, S): the batch is dim 1
    return 1 if (x.dim() >= 2 and x.shape[0] == 3 and x.shape[1] != 3) else 0


def batch_shardings(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, P]:
    """The batch dim over pod x data where the data size divides it."""
    dps, n_dp = dp_axes(mesh), dp_size(mesh)
    entry = dps if len(dps) > 1 else (dps[0] if dps else None)
    out = {}
    for k, x in batch.items():
        bdim = _batch_dim(x)
        if x.dim() == 0 or n_dp <= 1 or x.shape[bdim] % n_dp:
            out[k] = P()
            continue
        entries = [None] * x.dim()
        entries[bdim] = entry
        out[k] = P(*entries)
    return out


def cache_shardings(caches, mesh):
    """Decode caches: batch (dim 1 of a stacked leaf) over the data axes and
    the slots (dim 2 of a rank >= 4 leaf, at least 256) over ``model`` (and
    over ``data`` too where the batch is not cut); ``None`` leaves stay
    ``None``."""
    from repro_torch.models.model import cache_map

    dps, n_dp = dp_axes(mesh), dp_size(mesh)
    entry = dps if len(dps) > 1 else (dps[0] if dps else None)
    sizes = mesh_axis_sizes(mesh)

    def one(x):
        entries = [None] * x.dim()
        used_batch = False
        if x.dim() >= 2 and n_dp > 1 and x.shape[1] % n_dp == 0:
            entries[1] = entry
            used_batch = True
        if x.dim() >= 4 and "model" in sizes:
            if x.shape[2] % sizes["model"] == 0 and x.shape[2] >= 256:
                entries[2] = "model"
                if (not used_batch and "data" in sizes
                        and x.shape[2] % (sizes["model"] * sizes["data"]) == 0):
                    entries[2] = ("data", "model")
        return P(*entries) if any(e is not None for e in entries) else P()

    return cache_map(one, caches)


# ---------------------------------------------------------------------------
# what a rank owns
# ---------------------------------------------------------------------------


def local_box(spec: P, shape: Tuple[int, ...], coord: Mapping[str, int], mesh) -> Box:
    """``(start, stop)`` per dim of the part of a ``shape`` tensor that the
    rank at ``coord`` (``{axis: index}``) owns under ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    box = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        if e is None:
            box.append((0, int(n)))
            continue
        k, i = 1, 0
        for a in (e if isinstance(e, tuple) else (e,)):
            i = i * sizes[a] + coord[a]
            k *= sizes[a]
        if n % k:
            raise ValueError(f"partition {spec} does not divide dim {d} of {tuple(shape)}")
        step = int(n) // k
        box.append((i * step, (i + 1) * step))
    return tuple(box)


def mesh_coords(mesh) -> List[Dict[str, int]]:
    """Every rank's coordinate, in rank order (ranks row-major over the axes)."""
    sizes = mesh_axis_sizes(mesh)
    return [dict(zip(sizes, c)) for c in itertools.product(*(range(n) for n in sizes.values()))]


def whole_shape(local: Tuple[int, ...], spec: P, mesh) -> Tuple[int, ...]:
    """The whole shape of which a rank's part under ``spec`` is ``local``
    (every cut dim is cut evenly, ``local_box``)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for d, n in enumerate(local):
        e = spec[d] if d < len(spec) else None
        k = 1
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            k *= sizes[a]
        out.append(int(n) * k)
    return tuple(out)


def box_index(box: Box) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in box)


def local_slice(x: torch.Tensor, spec: P, coord: Mapping[str, int], mesh) -> torch.Tensor:
    """The rank's part of ``x`` (a view)."""
    if x.dim() == 0 or not any(e is not None for e in spec):
        return x
    return x[box_index(local_box(spec, tuple(x.shape), coord, mesh))]


def _walk2(tree, plan, fn: Callable[[Any, P], Any]):
    """Rebuild ``tree`` with ``fn(tensor, partition)`` at every tensor."""
    if tree is None:
        return None
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.codes, plan.codes),
                               tuple(fn(s, p) for s, p in zip(tree.scales, plan.scales)),
                               tree.shape, tree.config)
    if isinstance(tree, FactoredMoment):
        return FactoredMoment(fn(tree.row, plan.row), fn(tree.col, plan.col), tree.shape)
    if isinstance(tree, torch.Tensor):
        return fn(tree, plan)
    if isinstance(tree, ChainState):
        return ChainState(_walk2(s, p, fn) for s, p in zip(tree.states, plan.states))
    if isinstance(tree, PartitionState):
        return PartitionState({k: _walk2(tree.states[k], plan.states[k], fn) for k in tree.states},
                              tree.param_paths)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk2(s, p, fn) for s, p in zip(tree, plan)))
    if isinstance(tree, dict):
        return {k: _walk2(v, plan[k], fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk2(s, p, fn) for s, p in zip(tree, plan))
    return tree


def map_plan(fn: Callable[[torch.Tensor, P], Any], tree, plan):
    """``tree`` with every tensor ``t`` replaced by ``fn(t, its partition)``."""
    return _walk2(tree, plan, fn)


def plan_leaves(tree, plan) -> Iterator[Tuple[torch.Tensor, P]]:
    """``(tensor, partition)`` pairs of a tree and its plan."""
    out = []
    _walk2(tree, plan, lambda t, p: out.append((t, p)) or t)
    return iter(out)


def plan_nbytes(tree, plan, coord: Mapping[str, int], mesh) -> int:
    """Bytes the rank at ``coord`` holds of ``tree`` (a tree of whole
    tensors, or of ``meta`` tensors) under ``plan``."""
    total = 0
    for t, spec in plan_leaves(tree, plan):
        box = local_box(spec, tuple(t.shape), coord, mesh) if t.dim() else ()
        total += _numel([b - a for a, b in box]) * t.element_size()
    return int(total)
