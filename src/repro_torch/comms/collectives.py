"""The collectives of the mesh path, over ``torch.distributed``.

The backend rule: NCCL when each rank has a card of its own; gloo on the
CPU and when ranks share a card. gloo takes no CUDA tensor for these
collectives, so under gloo a CUDA tensor goes through host memory: it is
copied to the host, moved, and copied back (``through_host`` says whether
a group does this). That is the wire's cost on such a run, not a fallback:
the compute stays on the card.

``all_gather`` stacks every rank's tensor in rank order (equal shapes);
``all_to_all`` sends piece ``j`` of a ``(n, ...)`` tensor to the group's
``j``-th rank and returns the ``(n, ...)`` pieces it received, in the
group's rank order.

Two contexts serve the roofline (``repro_torch.roofline``):

* ``recording()`` yields a list that every collective call appends its
  ``(kind, result bytes, group size)`` to while the context is open:
  ``all_gather`` and ``merge_max`` (an all-gather) as ``all-gather``,
  ``all_to_all`` as ``all-to-all`` (``roofline.analysis.collective_bytes``
  prices them). With no context open a call pays one test of an empty
  list.
* ``without_world(world)``: the calls move nothing and return empty tensors
  of their results' shapes (``meta`` in, ``meta`` out), so the mesh step's
  layouts can be walked with no process group; a group is then a
  ``Ranks`` tuple (``None``: the ``world`` ranks).
"""

from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["through_host", "all_gather", "all_to_all", "merge_max", "Ranks", "recording",
           "without_world"]

Call = Tuple[str, int, int]  # (kind, result bytes, group size)
# the open recordings, innermost last: module state, not a context
# variable, so the collectives of a backward pass that autograd runs on its
# own thread are recorded too
_RECORDS: List[List[Call]] = []
_DRY_WORLD: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "repro_collective_dry_world", default=None)


class Ranks(tuple):
    """A process group's ranks, standing in for the group without a world."""


@contextlib.contextmanager
def recording() -> Iterator[List[Call]]:
    """Within it, every collective appends its ``(kind, result bytes, group
    size)`` to the yielded list (the innermost open one)."""
    calls: List[Call] = []
    _RECORDS.append(calls)
    try:
        yield calls
    finally:
        _RECORDS.remove(calls)


def _record(kind: str, out: torch.Tensor, group_size: int) -> None:
    if _RECORDS:
        _RECORDS[-1].append((kind, out.numel() * out.element_size(), int(group_size)))


@contextlib.contextmanager
def without_world(world: int) -> Iterator[None]:
    """Within it, collectives move nothing and return empty results of the
    right shapes (the layout reckoning of ``train.mesh.MeshStep``)."""
    token = _DRY_WORLD.set(int(world))
    try:
        yield
    finally:
        _DRY_WORLD.reset(token)


def _size(group) -> int:
    dry = _DRY_WORLD.get()
    if dry is None:
        return dist.get_world_size(group)
    return dry if group is None else len(group)


def through_host(t: torch.Tensor, group=None) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``(world, *t.shape)``: every rank's ``t`` in rank order."""
    n = _size(group)
    src = t.contiguous()
    if _DRY_WORLD.get() is not None:
        out = src.new_empty((n,) + tuple(src.shape))
        _record("all-gather", out, n)
        return out
    dev = src.device
    if through_host(src, group):
        src = src.cpu()
    out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    with warnings.catch_warnings():  # all_gather_into_tensor's rename notice
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out.reshape(-1), src.reshape(-1), group=group)
    _record("all-gather", out, n)
    return out.to(dev)


def all_to_all(pieces: torch.Tensor, group=None) -> torch.Tensor:
    """Piece ``j`` to rank ``j`` of ``group``; returns what each sent here."""
    src = pieces.contiguous()
    if _DRY_WORLD.get() is not None:
        out = torch.empty_like(src)
        _record("all-to-all", out, _size(group))
        return out
    dev = src.device
    if through_host(src, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _record("all-to-all", out, _size(group))
    return out.to(dev)


def merge_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks of ``group``, NaN-propagating
    (``torch.amax`` over the gathered copies; gloo's MAX is not)."""
    return torch.amax(all_gather(x, group), dim=0)
